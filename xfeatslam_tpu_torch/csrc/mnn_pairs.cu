// Mutual-NN primitives over aligned descriptor-bank pairs, scored over the
// valid columns only, never storing the similarity matrix.
//
// Replaces: xfeatslam_tpu/ops/pallas_kernels.py mutual_nn_pairs
// (:595-657; body _mnn_pair_kernel :543-592) through the entry point
// mnn_pairs, and similarity_top2 (:84-126; body _top2_kernel :65-80), the
// single-pair matcher behind mutual_nn_top2 and match_mutual_nn's fused
// route, through the entry point similarity_top2. Both entries instantiate
// one kernel template: mnn_pairs with the column pass (PAIRS), similarity_top2
// without it, so that their launches are counted apart. The TPU kernels need
// N % 256 == 0 (their row tile); here any N is taken.
//
// For pair p and row i of a[p] (every row, valid or not): s1 = max_j
// a[p,i].b[p,j] over columns with vb[p,j], i1 = the first j reaching it,
// s2 = the max over every valid column but i1 (a tie with s1 gives s2 = s1);
// a row with no valid column gets s1 = s2 = -inf, i1 = 0. mnn_pairs writes
// s1 and s2 as distances (2 - 2s) * 512, and for each valid column j the
// first row i with va[p,i] that maximizes the same similarity (col_best;
// 0 where the column is invalid or no row is valid).
//
// What bounds it on an H100. The main path's frames hold 124-176 valid
// keypoints in their K = 1000 slots, a prefix of each bank (ops/detect.py
// takes a sorted top-k). At batch 32 (31 pairs) all rows against the valid
// columns are about 0.6 GFLOP, 9 us at the 67 TFLOP/s float32 peak of the
// CUDA cores, and the bytes (16 MB) take 5 us; one pair at N = M = 1000
// (similarity_top2) is about 20 MFLOP, 0.3 us. Neither is what the kernel
// takes: every CTA runs a chain of dependent steps (mask fetch, list,
// gather of the first tiles, row merge) that costs a few microseconds
// whatever its size, and the 4 x 4 float32 blocks below read one 128-bit
// shared word per eight FMAs. PERF.md has the measured split.
//
// Design:
// 1. Valid columns only, whatever the mask. Each CTA stages its pair's mask
//    in shared memory and builds the ordered list of its valid columns
//    (per-warp __ballot_sync counts, a prefix over the warps, a second
//    ballot pass that writes each index at its place), then walks that list
//    in tiles, skipping the groups of 16 columns past its end. The list
//    keeps column order, so the strict-> update and the top-2 merges below
//    still give ties to the first column. The grid is sized from P and N
//    only: the host never reads the valid count.
// 2. One pass for mutual_nn_pairs. From each tile, each thread takes its
//    columns' best over its valid rows (the first row on a tie), a shuffle
//    and shared memory combine the CTA's threads, and one 64-bit atomicMax
//    per (CTA, valid column) merges the CTAs into a (P, M) scratch of keys
//    (order-preserving bits of s) << 32 | (0xFFFFFFFF - row), with -0.0
//    made +0.0 so that it ties as it does in torch.argmax. A larger key is a
//    larger similarity, then a smaller row; max does not depend on the order
//    of the atomics, so the result is deterministic. The last CTA of each
//    pair to finish (a counter after __threadfence) decodes the pair's keys
//    into col_best, so the wrapper adds no elementwise launch. The row and
//    column bests come from the same computed similarities.
// 3. A grid that fills the card. A CTA has 256 threads or more and takes
//    64 rows of a; when P * ceil(N / 64) would give fewer than two CTAs per
//    SM (one pair at N = 1000: 16 CTAs on 132 SMs), it takes 16 rows (63
//    CTAs) and splits each round of the list over eight slices of 64
//    threads, 32 columns each, whose partial row top-2s are merged at the
//    end. Splitting the columns over CTAs would fill the card too, but needs
//    a second launch to merge; inside one CTA the merge is a shared-memory
//    step.
// 4. Asynchronous copies. The a tile and each round of valid b rows (256 B
//    each, gathered by the list) arrive by 16-byte cp.async into a ring of
//    two rounds, so the next round loads while this one is multiplied; TMA
//    copies boxes and does not fit a gather of scattered rows. Rows are
//    padded to 68 floats and read as float4 along d, which keeps the inner
//    loop's shared-memory reads free of bank conflicts (the 8 threads of a
//    phase read rows 68 floats apart: banks 4*tx + d mod 32).
// 5. Float32 on the CUDA cores. Each thread owns a 4 x 4 block (rows
//    ty*4+i, columns tx+16*j of its tile); every similarity is the fmaf
//    chain over d = 0..63 in order from 0.f, as in the first version of
//    this kernel, so the values are unchanged. Tensor cores are not used:
//    bf16 (what the TPU ran), TF32 and 3xTF32 all round the similarities
//    differently, which moves matches at the max_dist and ratio thresholds;
//    and after step 1 the float32 work is not what bounds the time.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <atomic>

namespace {

constexpr int kD = 64;
constexpr int kLd = kD + 4;   // padded row of a shared tile, in floats
constexpr int kMaxM = 16384;  // columns the shared list holds (4 B each)
constexpr unsigned kFull = 0xffffffffu;

typedef unsigned long long u64;

// A CTA takes TM rows of a and walks its pair's list of valid columns in
// rounds of S tiles of TN (64 or 32), one tile to each of its S slices of
// TM*4 threads. Its dynamic shared memory: a ring of two rounds of b tiles
// (which first holds the staged column mask, and last the slices' partial
// row results), the a tile, the column keys of each warp (PAIRS only), 32
// ints of per-warp counts, and the list of valid columns (M ints).
template <int TM, int S, int TN, bool PAIRS>
struct Layout {
  static constexpr int kSlice = TM * 4;
  static constexpr int kThreads = kSlice * S;
  static constexpr int kWarps = kThreads / 32;
  static constexpr size_t kRing = 2 * S * TN * kLd * sizeof(float);
  static constexpr size_t kA = TM * kLd * sizeof(float);
  static constexpr size_t kKeys = PAIRS ? kWarps * TN * sizeof(u64) : 0;
  static constexpr size_t kCounts = 32 * sizeof(int);
  static size_t bytes(int M) {
    return kRing + kA + kKeys + kCounts + (size_t)M * sizeof(int);
  }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int kPending>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(kPending) : "memory");
}

// Rows [first, min(first + n, count)) of a (count, 64) bank into a padded
// tile: tile row r comes from bank row rows[first + r] (first + r when rows
// is null). Tile rows past count are left as they are: the callers never
// use what is computed from them.
template <int kThreads>
__device__ __forceinline__ void load_tile(float* dst, const float* src,
                                          const int* rows, int first, int n,
                                          int count, int tid) {
  const int chunks = max(0, min(n, count - first)) * 16;
#pragma unroll 4
  for (int q = tid; q < chunks; q += kThreads) {
    const int r = q >> 4, k = q & 15;
    const int row = rows ? rows[first + r] : first + r;
    cp_async16(dst + r * kLd + k * 4, src + (size_t)row * kD + k * 4);
  }
}

// acc[i][j] = a[row ty*4+i] . b[column tx+16*j] of the tile for the first
// JN groups of 16 columns: the fmaf chain over d = 0..63 in order.
template <int JN>
__device__ __forceinline__ void tile_dot(const float* As, const float* Bt,
                                         int ty, int tx, float (&acc)[4][4]) {
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
#pragma unroll
  for (int d = 0; d < kD; d += 4) {
    float4 av[4], bv[JN];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      av[i] = *reinterpret_cast<const float4*>(As + (ty * 4 + i) * kLd + d);
#pragma unroll
    for (int j = 0; j < JN; ++j)
      bv[j] = *reinterpret_cast<const float4*>(Bt + (tx + 16 * j) * kLd + d);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// The column key: order-preserving bits of s above the complemented row.
__device__ __forceinline__ u64 col_key(float s, int row) {
  unsigned u = __float_as_uint(s);
  if (u == 0x80000000u) u = 0u;  // -0.0 ties with +0.0
  u = (u & 0x80000000u) ? ~u : (u | 0x80000000u);
  return (u64)u << 32 | (0xffffffffu - (unsigned)row);
}

// Fold the top-2 (os1, os2, oi) of other columns into (s1, s2, i1): the
// larger best wins, the smaller column on a tie.
__device__ __forceinline__ void merge_top2(float& s1, float& s2, int& i1,
                                           float os1, float os2, int oi) {
  if (os1 > s1 || (os1 == s1 && oi < i1)) {
    s2 = fmaxf(s1, os2);
    s1 = os1;
    i1 = oi;
  } else {
    s2 = fmaxf(os1, s2);
  }
}

template <int TM, int S, int TN, bool PAIRS>
__global__ void __launch_bounds__(TM * 4 * S)
mnn_kernel(const float* __restrict__ a,      // (P,N,64)
           const float* __restrict__ b,      // (P,M,64)
           const uint8_t* __restrict__ va,   // (P,N), PAIRS only
           const uint8_t* __restrict__ vb,   // (P,M)
           float* __restrict__ out1,         // (P,N) s1, or its distance
           float* __restrict__ out2,         // (P,N) s2, or its distance
           int* __restrict__ i1_out,         // (P,N)
           int* __restrict__ col_out,        // (P,M), PAIRS only
           u64* __restrict__ keys,           // (P,M) zeroed, PAIRS only
           u64* __restrict__ done,           // (P,) zeroed, PAIRS only
           int N, int M) {
  using L = Layout<TM, S, TN, PAIRS>;
  constexpr int NT = L::kThreads, NW = L::kWarps;
  constexpr int kSliceWarps = L::kSlice / 32;
  constexpr int kGroups = TN / 16;  // groups of 16 columns per tile
  static_assert(L::kRing >= kMaxM, "the mask is staged in the ring");
  extern __shared__ __align__(16) unsigned char smem[];
  float* ring = reinterpret_cast<float*>(smem);
  float* As = reinterpret_cast<float*>(smem + L::kRing);
  u64* wkeys = reinterpret_cast<u64*>(smem + L::kRing + L::kA);
  int* wcount = reinterpret_cast<int*>(smem + L::kRing + L::kA + L::kKeys);
  int* cols = wcount + 32;

  const int p = blockIdx.y;
  const int row0 = blockIdx.x * TM;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int slice = tid / L::kSlice, st = tid % L::kSlice;
  const int tx = st & 15, ty = st >> 4;
  const float* Bm = b + (size_t)p * M * kD;

  load_tile<NT>(As, a + (size_t)p * N * kD, nullptr, row0, TM, N, tid);
  cp_async_commit();

  // the column mask, staged in the ring (free until the list is built)
  uint8_t* vs = reinterpret_cast<uint8_t*>(ring);
  const uint8_t* V = vb + (size_t)p * M;
#pragma unroll 16
  for (int j = tid; j < M; j += NT) vs[j] = V[j];
  bool rv[4];  // this thread's rows are valid for the column pass
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = row0 + ty * 4 + i;
    rv[i] = PAIRS && r < N && va[(size_t)p * N + r];
  }
  __syncthreads();

  // the ordered list of valid columns: warp w owns columns [lo, hi)
  const int seg = (M + NW * 32 - 1) / (NW * 32) * 32;
  const int lo = warp * seg, hi = min(M, lo + seg);
  int count = 0;
#pragma unroll 4
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    count += __popc(__ballot_sync(kFull, j < hi && vs[j]));
  }
  if (lane == 0) wcount[warp] = count;
  __syncthreads();
  int at = 0, nvalid = 0;
#pragma unroll
  for (int w = 0; w < NW; ++w) {
    at += w < warp ? wcount[w] : 0;
    nvalid += wcount[w];
  }
#pragma unroll 4
  for (int j0 = lo; j0 < hi; j0 += 32) {
    const int j = j0 + lane;
    const bool v = j < hi && vs[j];
    const unsigned bal = __ballot_sync(kFull, v);
    if (v) cols[at + __popc(bal & ((1u << lane) - 1u))] = j;
    at += __popc(bal);
  }
  __syncthreads();  // the list is complete and the ring is free

  constexpr int kRound = S * TN;  // columns of the list per round
  const int nrounds = (nvalid + kRound - 1) / kRound;
  if (nrounds > 0) load_tile<NT>(ring, Bm, cols, 0, kRound, nvalid, tid);
  cp_async_commit();

  float s1[4], s2[4];
  int i1[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    s1[i] = -INFINITY;
    s2[i] = -INFINITY;
    i1[i] = 0;
  }

  for (int r = 0; r < nrounds; ++r) {
    if (r + 1 < nrounds) {
      load_tile<NT>(ring + ((r + 1) & 1) * kRound * kLd, Bm, cols,
                    (r + 1) * kRound, kRound, nvalid, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // round r (and the a tile) landed for every thread

    // this slice's tile; whether it holds a valid column is the same for
    // every thread of the slice (whole warps)
    const int base = r * kRound + slice * TN;
    const bool busy = base < nvalid;
    float acc[4][4];
    if (busy) {
      const float* Bt = ring + ((r & 1) * S + slice) * TN * kLd;
      // only the groups of 16 columns that hold a valid column
      switch (min(kGroups, (nvalid - base + 15) / 16)) {
        case 4: tile_dot<4>(As, Bt, ty, tx, acc); break;
        case 3: tile_dot<3>(As, Bt, ty, tx, acc); break;
        case 2: tile_dot<2>(As, Bt, ty, tx, acc); break;
        default: tile_dot<1>(As, Bt, ty, tx, acc); break;
      }
#pragma unroll
      for (int j = 0; j < kGroups; ++j) {  // increasing column order
        const int q = base + tx + 16 * j;
        if (q >= nvalid) break;
        const int c = cols[q];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = acc[i][j];
          if (v > s1[i]) {
            s2[i] = s1[i];
            s1[i] = v;
            i1[i] = c;
          } else if (v > s2[i]) {
            s2[i] = v;
          }
        }
      }
    }

    if constexpr (PAIRS) {
      // each column's best valid row of this CTA, the first on a tie
      if (busy) {
#pragma unroll
        for (int j = 0; j < kGroups; ++j) {
          float best = 0.f;
          int row = -1;
#pragma unroll
          for (int i = 0; i < 4; ++i)
            if (rv[i] && (row < 0 || acc[i][j] > best)) {
              best = acc[i][j];
              row = row0 + ty * 4 + i;
            }
          u64 key = row < 0 ? 0ull : col_key(best, row);
          const u64 other = __shfl_xor_sync(kFull, key, 16);  // same tx
          key = other > key ? other : key;
          if (lane < 16) wkeys[warp * TN + tx + 16 * j] = key;
        }
      }
      __syncthreads();
      const int ks = tid / TN, kc = tid % TN;  // a slice's column
      const int q = r * kRound + ks * TN + kc;
      if (ks < S && q < nvalid) {
        u64 key = 0;
#pragma unroll
        for (int w = 0; w < kSliceWarps; ++w) {
          const u64 k = wkeys[(ks * kSliceWarps + w) * TN + kc];
          key = k > key ? k : key;
        }
        if (key) atomicMax(keys + (size_t)p * M + cols[q], key);
      }
    }
    __syncthreads();  // every thread is done with round r's tiles and keys
  }
  cp_async_wait<0>();

  // merge the 16 partial results of each row (lanes of one half-warp),
  // then the slices' (in the ring, free now)
  float* part = ring;  // [3][S][TM]: s1, s2, i1
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    for (int o = 8; o > 0; o >>= 1)
      merge_top2(s1[i], s2[i], i1[i], __shfl_xor_sync(kFull, s1[i], o),
                 __shfl_xor_sync(kFull, s2[i], o),
                 __shfl_xor_sync(kFull, i1[i], o));
    if (tx == 0) {
      const int k = slice * TM + ty * 4 + i;
      part[k] = s1[i];
      part[S * TM + k] = s2[i];
      part[2 * S * TM + k] = __int_as_float(i1[i]);
    }
  }
  __syncthreads();
  if (tid < TM && row0 + tid < N) {
    float r1 = part[tid], r2 = part[S * TM + tid];
    int ri = __float_as_int(part[2 * S * TM + tid]);
#pragma unroll
    for (int k = 1; k < S; ++k)
      merge_top2(r1, r2, ri, part[k * TM + tid], part[(S + k) * TM + tid],
                 __float_as_int(part[(2 * S + k) * TM + tid]));
    const size_t o = (size_t)p * N + row0 + tid;
    out1[o] = PAIRS ? (2.f - 2.f * r1) * 512.f : r1;
    out2[o] = PAIRS ? (2.f - 2.f * r2) * 512.f : r2;
    i1_out[o] = ri;
  }

  if constexpr (PAIRS) {
    // the last CTA of the pair decodes its keys into col_best
    __threadfence();
    __syncthreads();
    if (tid == 0) wcount[0] = atomicAdd(done + p, 1ull) == gridDim.x - 1;
    __syncthreads();
    if (wcount[0]) {
      for (int c = tid; c < M; c += NT) {
        const u64 key = __ldcg(keys + (size_t)p * M + c);
        col_out[(size_t)p * M + c] =
            key ? (int)(0xffffffffu - (unsigned)key) : 0;
      }
    }
  }
}

// Rows per CTA: 64 (one slice of 64 columns) when that gives two CTAs per
// SM, else 16 (eight slices of 32 columns).
int row_tile(int P, int N) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return (long long)P * ((N + 63) / 64) >= 2LL * sms ? 64 : 16;
}

// Allow the kernel its shared memory at kMaxM columns, once per device.
template <int TM, int S, int TN, bool PAIRS>
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(mnn_kernel<TM, S, TN, PAIRS>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)Layout<TM, S, TN, PAIRS>::bytes(kMaxM));
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int TM, int S, int TN, bool PAIRS>
int launch(const float* a, const float* b, const uint8_t* va,
           const uint8_t* vb, float* out1, float* out2, int* i1, int* col,
           u64* scratch, int P, int N, int M, cudaStream_t stream) {
  using L = Layout<TM, S, TN, PAIRS>;
  const cudaError_t err = allow_smem<TM, S, TN, PAIRS>();
  if (err != cudaSuccess) return (int)err;
  const dim3 grid((N + TM - 1) / TM, P);
  u64* keys = scratch;
  u64* done = PAIRS ? scratch + (size_t)P * M : nullptr;
  mnn_kernel<TM, S, TN, PAIRS><<<grid, L::kThreads, L::bytes(M), stream>>>(
      a, b, va, vb, out1, out2, i1, col, keys, done, N, M);
  return (int)cudaGetLastError();
}

template <bool PAIRS>
int dispatch(const float* a, const float* b, const uint8_t* va,
             const uint8_t* vb, float* out1, float* out2, int* i1, int* col,
             u64* scratch, int P, int N, int M, void* stream) {
  if (M > kMaxM) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  if (row_tile(P, N) == 64)
    return launch<64, 1, 64, PAIRS>(a, b, va, vb, out1, out2, i1, col,
                                    scratch, P, N, M, s);
  return launch<16, 8, 32, PAIRS>(a, b, va, vb, out1, out2, i1, col, scratch,
                                  P, N, M, s);
}

}  // namespace

// The rows of a that one CTA of either entry takes for P pairs of N rows.
extern "C" int mnn_row_tile(int P, int N) { return row_tile(P, N); }

// P pairs: best and second (P,N) distances, idx (P,N), col_best (P,M);
// scratch is P*M + P zeroed 64-bit words.
extern "C" int mnn_pairs(const float* a, const float* b, const uint8_t* va,
                         const uint8_t* vb, float* best, float* second,
                         int* idx, int* col_best, u64* scratch, int P, int N,
                         int M, void* stream) {
  if (P == 0) return (int)cudaSuccess;
  if (N == 0)  // no row: every column's best row is 0
    return (int)cudaMemsetAsync(col_best, 0, (size_t)P * M * sizeof(int),
                                (cudaStream_t)stream);
  return dispatch<true>(a, b, va, vb, best, second, idx, col_best, scratch, P,
                        N, M, stream);
}

// One pair: a (N,64) against b (M,64) under the column mask vb (M,).
extern "C" int similarity_top2(const float* a, const float* b,
                               const uint8_t* vb, float* s1, float* s2,
                               int* i1, int N, int M, void* stream) {
  if (N == 0) return (int)cudaSuccess;
  return dispatch<false>(a, b, nullptr, vb, s1, s2, i1, nullptr, nullptr, 1,
                         N, M, stream);
}
