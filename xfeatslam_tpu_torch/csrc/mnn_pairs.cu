// Row-wise top-2 similarity over aligned descriptor-bank pairs, never
// storing the similarity matrix.
//
// Replaces: xfeatslam_tpu/ops/pallas_kernels.py mutual_nn_pairs
// (:595-657; body _mnn_pair_kernel :543-592) through the entry point
// mnn_rows, and similarity_top2 (:84-126; body _top2_kernel :65-80), the
// single-pair matcher behind mutual_nn_top2 and match_mutual_nn's fused
// route, through the entry point similarity_top2: the P = 1 case of the
// same kernel, given its own entry so that its launches are counted apart.
// The TPU kernel needs N % 256 == 0 (its row tile); here any N is taken.
//
// For pair p and row i of a[p]: s1 = max_j a[p,i].b[p,j] over columns with
// vb[p,j], i1 = the first j reaching it, s2 = the max over every valid
// column but i1 (so a tie with s1 gives s2 = s1). A row with no valid column
// gets s1 = s2 = -inf, i1 = 0. The TPU kernel also computes each column's
// best row in the same pass; here the wrapper launches this kernel a second
// time on (b, a) under the row mask va, which gives that without a cross-
// block reduction. Each dot is the same fmaf chain over d = 0..63 in both
// launches, and fmaf is symmetric in its factors, so the two launches see
// bit-identical similarities.
//
// What bounds it on an H100: float32 operations. At batch 32 (31 pairs,
// K = 1000, D = 64) one launch is 4.0 GFLOP, about 59 us at the 67 TFLOP/s
// float32 peak of the CUDA cores; the bytes (16 MB) take 5 us. For one pair
// at N = M = 1000 (similarity_top2) it is 0.128 GFLOP, about 1.9 us at that
// peak, against 0.5 MB of bytes (0.15 us). What limits that case today is
// occupancy, not the arithmetic: the grid is ceil(N/64) = 16 CTAs on 132
// SMs, so 116 SMs idle; splitting the columns over more CTAs (with a merge
// pass) is a later redesign.
//
// Design: float32 on the CUDA cores. A CTA takes one pair and a 64-row tile
// of a, kept transposed in shared memory; it walks over b in 64-column
// tiles staged the same way. Each of the 256 threads owns a 4 x 4 block
// (rows ty*4+i, columns tx+16*j), so per tile and per d it reads 8 shared
// words for 16 FMAs. The running (s1, s2, i1) per row is updated in column
// order (if v > s1: s2 = s1, s1 = v, i1 = j; else if v > s2: s2 = v), then
// the 16 threads of a row merge with shuffles: the larger s1 wins, the
// smaller index on a tie, and s2 = max(loser.s1, winner.s2). bf16 tensor-
// core inputs, as the TPU path used, are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kD = 64;
constexpr int kTM = 64;  // rows of a per CTA
constexpr int kTN = 64;  // columns of b per tile
constexpr int kThreads = 256;
constexpr unsigned kFull = 0xffffffffu;

__global__ void __launch_bounds__(kThreads)
mnn_rows_kernel(const float* __restrict__ a,     // (P,N,64)
                const float* __restrict__ b,     // (P,M,64)
                const uint8_t* __restrict__ vb,  // (P,M)
                float* __restrict__ s1_out,      // (P,N)
                float* __restrict__ s2_out,      // (P,N)
                int* __restrict__ i1_out,        // (P,N)
                int N, int M) {
  __shared__ float As[kD][kTM + 1];
  __shared__ float Bs[kD][kTN + 1];
  __shared__ uint8_t vs[kTN];

  const int p = blockIdx.y;
  const int row0 = blockIdx.x * kTM;
  const float* A = a + (size_t)p * N * kD;
  const float* Bm = b + (size_t)p * M * kD;
  const uint8_t* V = vb + (size_t)p * M;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;

  for (int t = tid; t < kTM * kD; t += kThreads) {
    const int r = t / kD, d = t % kD;
    As[d][r] = row0 + r < N ? A[(size_t)(row0 + r) * kD + d] : 0.f;
  }

  float s1[4], s2[4];
  int i1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s1[i] = -INFINITY;
    s2[i] = -INFINITY;
    i1[i] = 0;
  }

  for (int col0 = 0; col0 < M; col0 += kTN) {
    __syncthreads();  // the previous tile has been consumed
    for (int t = tid; t < kTN * kD; t += kThreads) {
      const int c = t / kD, d = t % kD;
      Bs[d][c] = col0 + c < M ? Bm[(size_t)(col0 + c) * kD + d] : 0.f;
    }
    if (tid < kTN) vs[tid] = (col0 + tid < M) && V[col0 + tid];
    __syncthreads();

    float acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < kD; ++d) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = As[d][ty * 4 + i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = Bs[d][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {  // increasing column order
      const int c = tx + 16 * j;
      if (!vs[c]) continue;
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float v = acc[i][j];
        if (v > s1[i]) {
          s2[i] = s1[i];
          s1[i] = v;
          i1[i] = col0 + c;
        } else if (v > s2[i]) {
          s2[i] = v;
        }
      }
    }
  }

  // merge the 16 partial results of each row (lanes of one half-warp)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int o = 8; o > 0; o >>= 1) {
      const float os1 = __shfl_xor_sync(kFull, s1[i], o);
      const float os2 = __shfl_xor_sync(kFull, s2[i], o);
      const int oi = __shfl_xor_sync(kFull, i1[i], o);
      const bool other = os1 > s1[i] || (os1 == s1[i] && oi < i1[i]);
      if (other) {
        s2[i] = fmaxf(s1[i], os2);
        s1[i] = os1;
        i1[i] = oi;
      } else {
        s2[i] = fmaxf(os1, s2[i]);
      }
    }
    const int r = row0 + ty * 4 + i;
    if (tx == 0 && r < N) {
      const size_t o = (size_t)p * N + r;
      s1_out[o] = s1[i];
      s2_out[o] = s2[i];
      i1_out[o] = i1[i];
    }
  }
}

}  // namespace

extern "C" int mnn_rows(const float* a, const float* b, const uint8_t* vb,
                        float* s1, float* s2, int* i1, int P, int N, int M,
                        void* stream) {
  if (P == 0 || N == 0) return (int)cudaSuccess;
  dim3 grid((N + kTM - 1) / kTM, P);
  mnn_rows_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      a, b, vb, s1, s2, i1, N, M);
  return (int)cudaGetLastError();
}

// One pair: a (N,64) against b (M,64) under the column mask vb (M,).
extern "C" int similarity_top2(const float* a, const float* b,
                               const uint8_t* vb, float* s1, float* s2,
                               int* i1, int N, int M, void* stream) {
  return mnn_rows(a, b, vb, s1, s2, i1, 1, N, M, stream);
}
