// Bilinear descriptor sampling at keypoints: normalize the tap rows,
// combine them with the bilinear weights, renormalize.
//
// Replaces: xfeatslam_tpu/ops/pallas_kernels.py bilinear_desc_sample
// (:504-540; body _desc_sample_kernel :451-501).
//
// out[b,k] = normalize(sum_t w4[b,k,t] * normalize(feats[b, idx4[b,k,t]]))
// with normalize(v) = v * rsqrt(|v|^2 + 1e-12). The caller folds
// out-of-bounds taps and invalid keypoints into zero weights, so a row whose
// weights are all zero comes out zero.
//
// What bounds it on an H100: bytes. Each keypoint reads at most 4 rows of
// 256 B plus 32 B of taps and writes 256 B, against ~800 float ops; at
// batch 32 and K=1000 that is ~41 MB at most, about 12 us at 3.35 TB/s.
//
// Design: one warp per keypoint, two channels per lane (float2 loads, so a
// tap row is one coalesced 256 B read). Each tap row is normalized with a
// warp reduction as it arrives, so the dense grid is never normalized as a
// whole (the TPU kernel normalizes the full (H8*W8,64) grid and then gathers
// with a one-hot matmul, the fast form on a TPU; on this card a direct
// gather reads only the rows the keypoints touch). Zero-weight taps are not
// read at all. K need not be a multiple of anything.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ float warp_sum(float s) {
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  return s;
}

__global__ void __launch_bounds__(kThreads)
desc_sample_kernel(const float* __restrict__ feats,  // (B,NP,64)
                   const int* __restrict__ idx4,     // (B,K,4)
                   const float* __restrict__ w4,     // (B,K,4)
                   float* __restrict__ out,          // (B,K,64)
                   int NP, int K, int total) {
  const int kp = blockIdx.x * kWarps + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (kp >= total) return;
  const float2* f = reinterpret_cast<const float2*>(feats) +
                    (size_t)(kp / K) * NP * 32;
  float2 acc = make_float2(0.f, 0.f);
#pragma unroll
  for (int t = 0; t < 4; ++t) {
    const float w = w4[(size_t)kp * 4 + t];
    if (w == 0.f) continue;  // uniform across the warp
    const float2 v = f[(size_t)idx4[(size_t)kp * 4 + t] * 32 + lane];
    const float sc = rsqrtf(warp_sum(v.x * v.x + v.y * v.y) + 1e-12f);
    acc.x += w * (v.x * sc);
    acc.y += w * (v.y * sc);
  }
  const float sc = rsqrtf(warp_sum(acc.x * acc.x + acc.y * acc.y) + 1e-12f);
  reinterpret_cast<float2*>(out)[(size_t)kp * 32 + lane] =
      make_float2(acc.x * sc, acc.y * sc);
}

}  // namespace

extern "C" int desc_sample(const float* feats, const int* idx4,
                           const float* w4, float* out, int B, int NP, int K,
                           void* stream) {
  const int total = B * K;
  if (total == 0) return (int)cudaSuccess;
  const int blocks = (total + kWarps - 1) / kWarps;
  desc_sample_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      feats, idx4, w4, out, NP, K, total);
  return (int)cudaGetLastError();
}
