// Orientation and rotated BRIEF at the ORB keypoints of every pyramid
// level, in one launch.
//
// Replaces orientation_maps and the gathers of describe in
// xfeatslam_tpu/models/orb.py orb_describe_all (:148-163, :174-204,
// :274-289), which is XLA code in the JAX package, not Pallas. There, and
// in the PyTorch counterpart (ops/cuda_kernels.orb_describe_plain), the
// intensity-centroid moments m10 and m01 are two 31x31 convolutions over
// every pixel of every level, of which ~1,000 pixels are read; this kernel
// sums the moments at the keypoints only.
//
// What it computes, as the plain version does, for keypoint k of a level
// (h, w):
//   (xi, yi) = the keypoint's (x, y) truncated to int and clamped to the
//     level;
//   m10 = sum of dx * img[yi + dy, xi + dx], m01 = sum of dy * img[...]
//     over the disc dx^2 + dy^2 <= 15^2, pixels outside the level 0 (the
//     convolutions' zero padding);
//   angle = atan2(m01, m10), ca = cos(angle), sa = sin(angle);
//   for each of the 256 pattern pairs (x1, y1, x2, y2): a point (px, py)
//     goes to (xi + round(ca px - sa py), yi + round(sa px + ca py)),
//     rounded half to even as torch.round, clamped to the level, and read
//     from the blurred level; bit = v1 < v2, written as float 0/1 times
//     the keypoint's valid flag; the angle is written for every slot.
// The moments are summed in double: at level 0 (integer pixels, |m| <
// 2^24) any order gives the plain version's float32 value exactly, and
// above it the sum is the exact sum rounded once. The rotation is computed
// with the plain version's float operations in its order (--fmad=false).
//
// What bounds it on an H100: bytes, barely. Per keypoint slot it reads 709
// disc pixels and 512 blurred pixels (~4.9 KB, mostly from L2) and writes
// 1 KB of bits; the ~8,000 float ops per slot are ~0.1 us at 67 TFLOP/s
// for 1,000 slots. A launch at 640x480 with 1,000 features is a few us.
//
// Design: one warp per keypoint slot, 8 per CTA, every level's slots in
// one grid (a level table passed by value). Lane l < 31 sums disc row
// l - 15; the 32 partials go through shared memory and lane 0 adds them in
// lane order (a fixed order, no atomics), then takes the angle; each lane
// then writes 8 of the 256 bits, neighbouring lanes on neighbouring bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 8;
constexpr int kThreads = 32 * kWarps;
constexpr int kRadius = 15;
constexpr int kBits = 256;

struct DescLevels {
  const float* img[kMaxLevels];    // (h, w) level image
  const float* blur[kMaxLevels];   // (h, w) blurred level image
  const float* kpts[kMaxLevels];   // (n, 2) (x, y) level coordinates
  const bool* valid[kMaxLevels];   // (n,)
  float* desc[kMaxLevels];         // (n, 256)
  float* angle[kMaxLevels];        // (n,)
  int h[kMaxLevels];
  int w[kMaxLevels];
  int kp_start[kMaxLevels + 1];
  int n;
};

__global__ void __launch_bounds__(kThreads)
orb_describe_kernel(DescLevels L, const float* __restrict__ pattern) {
  __shared__ double part[kWarps][32][2];
  __shared__ float rot[kWarps][2];

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = (int)blockIdx.x * kWarps + warp;
  const bool active = g < L.kp_start[L.n];
  int lvl = 0;
  while (lvl + 1 < L.n && g >= L.kp_start[lvl + 1]) ++lvl;
  const int k = g - L.kp_start[lvl];
  const int h = L.h[lvl], w = L.w[lvl];
  int xi = 0, yi = 0;
  if (active) {
    xi = min(max((int)L.kpts[lvl][2 * k], 0), w - 1);
    yi = min(max((int)L.kpts[lvl][2 * k + 1], 0), h - 1);
  }

  double s10 = 0.0, s01 = 0.0;
  if (active && lane <= 2 * kRadius) {
    const int dy = lane - kRadius;
    const int y = yi + dy;
    if (y >= 0 && y < h) {
      const float* __restrict__ row = L.img[lvl] + (size_t)y * w;
      double sum = 0.0;
      for (int dx = -kRadius; dx <= kRadius; ++dx) {
        const int x = xi + dx;
        if (dx * dx + dy * dy > kRadius * kRadius || x < 0 || x >= w) continue;
        const double v = (double)row[x];
        s10 += (double)dx * v;
        sum += v;
      }
      s01 = (double)dy * sum;
    }
  }
  part[warp][lane][0] = s10;
  part[warp][lane][1] = s01;
  __syncthreads();
  if (active && lane == 0) {
    double m10 = 0.0, m01 = 0.0;
    for (int i = 0; i < 32; ++i) {
      m10 += part[warp][i][0];
      m01 += part[warp][i][1];
    }
    const float a = atan2f((float)m01, (float)m10);
    L.angle[lvl][k] = a;
    rot[warp][0] = cosf(a);
    rot[warp][1] = sinf(a);
  }
  __syncthreads();
  if (!active) return;

  const float ca = rot[warp][0], sa = rot[warp][1];
  const float* __restrict__ blur = L.blur[lvl];
  const float v = L.valid[lvl][k] ? 1.f : 0.f;
  float* __restrict__ out = L.desc[lvl] + (size_t)k * kBits;
  for (int b = lane; b < kBits; b += 32) {
    float val[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float px = pattern[4 * b + 2 * e];
      const float py = pattern[4 * b + 2 * e + 1];
      const float rx = ca * px - sa * py;
      const float ry = sa * px + ca * py;
      const int gx = min(max(xi + (int)rintf(rx), 0), w - 1);
      const int gy = min(max(yi + (int)rintf(ry), 0), h - 1);
      val[e] = blur[(size_t)gy * w + gx];
    }
    out[b] = (val[0] < val[1] ? 1.f : 0.f) * v;
  }
}

}  // namespace

// img, blur, kpts, valid, desc, angle: host arrays of n device pointers;
// h, w, count: host arrays of n level sizes and keypoint slots; pattern:
// (256, 4) float32 on the device.
extern "C" int orb_describe(const void* const* img, const void* const* blur,
                            const void* const* kpts, const void* const* valid,
                            void* const* desc, void* const* angle,
                            const int* h, const int* w, const int* count,
                            int n, const float* pattern, void* stream) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  DescLevels L{};
  L.n = n;
  int slots = 0;
  for (int l = 0; l < n; ++l) {
    if (h[l] < 1 || w[l] < 1 || count[l] < 0)
      return (int)cudaErrorInvalidValue;
    L.img[l] = static_cast<const float*>(img[l]);
    L.blur[l] = static_cast<const float*>(blur[l]);
    L.kpts[l] = static_cast<const float*>(kpts[l]);
    L.valid[l] = static_cast<const bool*>(valid[l]);
    L.desc[l] = static_cast<float*>(desc[l]);
    L.angle[l] = static_cast<float*>(angle[l]);
    L.h[l] = h[l];
    L.w[l] = w[l];
    L.kp_start[l] = slots;
    slots += count[l];
  }
  L.kp_start[n] = slots;
  if (slots == 0) return (int)cudaSuccess;
  const int blocks = (slots + kWarps - 1) / kWarps;
  orb_describe_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(L,
                                                                     pattern);
  return (int)cudaGetLastError();
}
