// Bilinear descriptor sampling at keypoints: normalize the tap rows,
// combine them with the bilinear weights, renormalize. Two entries:
//
//  desc_sample    taps and weights given (idx4, w4): the interface of
//                 xfeatslam_tpu/ops/pallas_kernels.py bilinear_desc_sample
//                 (:504-540; body _desc_sample_kernel :451-501).
//  keypoint_desc  the whole descriptor stage after the top-k: the selected
//                 candidates' pixels and sub-pixel offsets decoded from the
//                 packed aux (xfeatslam_tpu/ops/detect.py _candidates_topk
//                 :462-471), the taps and weights (_desc_sample_pallas
//                 :474-503) and the sampling above, in one launch; it writes
//                 kpts (B,K,2) and desc (B,K,64).
//
// out[b,k] = normalize(sum_t w[t] * normalize(feats[b, idx[t]])) with
// normalize(v) = v * rsqrt(|v|^2 + 1e-12); a row whose weights are all zero
// (an invalid keypoint, or every tap out of bounds) comes out zero.
//
// What bounds it on an H100: bytes. Each valid keypoint reads at most 4
// grid rows of 256 B and writes 256 B; keypoint_desc also reads its top-k
// index, score and aux (16 B) and writes its kpts (8 B). At batch 32 and
// K=1000 that is ~10 MB, ~3 us at 3.35 TB/s; the work is ~800 float ops
// per keypoint.
//
// Design: half a warp per keypoint, four channels per lane, so a tap row
// is one 256 B read of 16-byte loads and a warp serves two keypoints. The
// four tap rows are loaded together (predicated on a nonzero weight, so an
// invalid keypoint reads no row) before the four 16-lane norm reductions,
// which run interleaved. Each tap row is normalized as it arrives, so the
// dense grid is never normalized as a whole (the TPU kernel normalizes the
// full (H8*W8,64) grid and gathers with a one-hot matmul, the fast form on
// a TPU; on this card a direct gather reads only the rows the keypoints
// touch). keypoint_desc computes the decode, the positions and the weights
// with the same float operations, in the same order, as the plain PyTorch
// version (ops/cuda_kernels.keypoint_desc_plain); this file is compiled with
// --fmad=false, because a contracted x*s - 0.5 moves floor().

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 128;
constexpr int kPerBlock = kThreads / 16;  // keypoints per CTA
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float half_warp_sum(float s) {
  for (int o = 8; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

__device__ __forceinline__ float dot4(float4 v) {
  return v.x * v.x + v.y * v.y + v.z * v.z + v.w * v.w;
}

// One keypoint's descriptor, lanes sub = 0..15 of a half warp holding
// channels 4*sub..4*sub+3. f: the image's grid rows as float4 (16 each).
// Every lane of the warp must call it (the reductions shuffle).
__device__ __forceinline__ float4 sample_keypoint(const float4* __restrict__ f,
                                                  const int idx[4],
                                                  const float w[4], int sub) {
  float4 r[4];
#pragma unroll
  for (int t = 0; t < 4; ++t)
    r[t] = w[t] != 0.f ? __ldg(f + (size_t)idx[t] * 16 + sub)
                       : make_float4(0.f, 0.f, 0.f, 0.f);
  float ss[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) ss[t] = dot4(r[t]);
  for (int o = 8; o > 0; o >>= 1) {
#pragma unroll
    for (int t = 0; t < 4; ++t) ss[t] += __shfl_xor_sync(kFull, ss[t], o);
  }
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    if (w[t] == 0.f) continue;
    const float sc = rsqrtf(ss[t] + 1e-12f);
    acc.x += w[t] * (r[t].x * sc);
    acc.y += w[t] * (r[t].y * sc);
    acc.z += w[t] * (r[t].z * sc);
    acc.w += w[t] * (r[t].w * sc);
  }
  const float sc = rsqrtf(half_warp_sum(dot4(acc)) + 1e-12f);
  return make_float4(acc.x * sc, acc.y * sc, acc.z * sc, acc.w * sc);
}

__global__ void __launch_bounds__(kThreads)
desc_sample_kernel(const float* __restrict__ feats,  // (B,NP,64)
                   const int* __restrict__ idx4,     // (B,K,4)
                   const float* __restrict__ w4,     // (B,K,4)
                   float* __restrict__ out,          // (B,K,64)
                   int NP, int K, int total) {
  const int kp = blockIdx.x * kPerBlock + (threadIdx.x >> 4);
  const int sub = threadIdx.x & 15;
  const bool live = kp < total;
  int idx[4];
  float w[4];
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    idx[t] = live ? idx4[(size_t)kp * 4 + t] : 0;
    w[t] = live ? w4[(size_t)kp * 4 + t] : 0.f;
  }
  const float4* f = reinterpret_cast<const float4*>(feats) +
                    (size_t)(live ? kp / K : 0) * NP * 16;
  const float4 d = sample_keypoint(f, idx, w, sub);
  if (live) reinterpret_cast<float4*>(out)[(size_t)kp * 16 + sub] = d;
}

__global__ void __launch_bounds__(kThreads)
keypoint_desc_kernel(const float* __restrict__ feats,      // (B,H8*W8,64)
                     const float* __restrict__ scores,     // (B,K)
                     const long long* __restrict__ sel,    // (B,K)
                     const float* __restrict__ aux,        // (B,H8,nc,W8)
                     float* __restrict__ kpts,             // (B,K,2)
                     float* __restrict__ desc,             // (B,K,64)
                     int H8, int W8, int nc, int K, int total, int subpixel,
                     float scale_x, float scale_y) {
  const int kp = blockIdx.x * kPerBlock + (threadIdx.x >> 4);
  const int sub = threadIdx.x & 15;
  const bool live = kp < total;
  const int b = live ? kp / K : 0;
  int idx[4] = {0, 0, 0, 0};
  float w[4] = {0.f, 0.f, 0.f, 0.f};
  float kx = 0.f, ky = 0.f;
  if (live) {
    // candidate (b, cy, r, cx) is pixel (cy*8 + ch/8, cx*8 + ch%8)
    const long long s = sel[kp];
    const bool valid = scores[kp] > 0.f;
    const int gi = (int)aux[(size_t)b * H8 * nc * W8 + s];
    const int ch = gi >> 18;
    const int cy = (int)(s / (nc * W8)), cx = (int)(s % W8);
    kx = (float)(cx * 8 + (ch & 7));
    ky = (float)(cy * 8 + (ch >> 3));
    if (subpixel) {
      kx = __fadd_rn(kx, __fsub_rn(__fdiv_rn((float)((gi >> 9) & 511), 255.f), 1.f));
      ky = __fadd_rn(ky, __fsub_rn(__fdiv_rn((float)(gi & 511), 255.f), 1.f));
    }
    // taps and weights as desc_taps: zero out of bounds and when invalid
    const float px = __fsub_rn(__fmul_rn(kx, scale_x), 0.5f);
    const float py = __fsub_rn(__fmul_rn(ky, scale_y), 0.5f);
    const float fx = floorf(px), fy = floorf(py);
    const float wx = __fsub_rn(px, fx), wy = __fsub_rn(py, fy);
    const float ux = __fsub_rn(1.f, wx), uy = __fsub_rn(1.f, wy);
    const int x0 = (int)fx, y0 = (int)fy;
    const float tw[4] = {__fmul_rn(ux, uy), __fmul_rn(wx, uy),
                         __fmul_rn(ux, wy), __fmul_rn(wx, wy)};
#pragma unroll
    for (int t = 0; t < 4; ++t) {
      const int yi = y0 + (t >> 1), xi = x0 + (t & 1);
      const bool inb = yi >= 0 && yi < H8 && xi >= 0 && xi < W8;
      idx[t] = min(max(yi, 0), H8 - 1) * W8 + min(max(xi, 0), W8 - 1);
      w[t] = (inb && valid) ? tw[t] : 0.f;
    }
  }
  const float4* f = reinterpret_cast<const float4*>(feats) +
                    (size_t)b * H8 * W8 * 16;
  const float4 d = sample_keypoint(f, idx, w, sub);
  if (live) {
    reinterpret_cast<float4*>(desc)[(size_t)kp * 16 + sub] = d;
    if (sub == 0)
      reinterpret_cast<float2*>(kpts)[kp] = make_float2(kx, ky);
  }
}

}  // namespace

extern "C" int desc_sample(const float* feats, const int* idx4,
                           const float* w4, float* out, int B, int NP, int K,
                           void* stream) {
  const int total = B * K;
  if (total == 0) return (int)cudaSuccess;
  const int blocks = (total + kPerBlock - 1) / kPerBlock;
  desc_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      feats, idx4, w4, out, NP, K, total);
  return (int)cudaGetLastError();
}

extern "C" int keypoint_desc(const float* feats, const float* scores,
                             const long long* sel, const float* aux,
                             float* kpts, float* desc, int B, int H8, int W8,
                             int nc, int K, int subpixel, float scale_x,
                             float scale_y, void* stream) {
  const int total = B * K;
  if (total == 0) return (int)cudaSuccess;
  const int blocks = (total + kPerBlock - 1) / kPerBlock;
  keypoint_desc_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      feats, scores, sel, aux, kpts, desc, H8, W8, nc, K, total, subpixel,
      scale_x, scale_y);
  return (int)cudaGetLastError();
}
