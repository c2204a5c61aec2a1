// FAST-9 at two thresholds, 3x3 non-maximum suppression and the border
// mask of every ORB pyramid level, in one launch.
//
// Replaces, per level, fast_score_map + nms3_mask + the EDGE mask of
// xfeatslam_tpu/models/orb.py orb_candidates (:93-131, :206-250), which is
// XLA code in the JAX package, not Pallas. Its PyTorch counterpart
// (ops/cuda_kernels.orb_fast_plain) builds the 16 circle pixels as one
// stacked tensor and runs ~20 elementwise kernels per threshold and level;
// this kernel reads each level image once.
//
// What it computes, as the plain version does, for each pixel p of a level
// and each threshold t (t0 = the initial, t1 = the minimum threshold):
//   circle pixel c_i = img[(y + dy_i) mod h, (x + dx_i) mod w] (the image
//     wraps around, as jnp.roll does in the JAX package);
//   brighter_i = c_i > p + t, darker_i = c_i < p - t;
//   a corner where nine consecutive circle pixels (with wrap-around) are
//     all brighter or all darker;
//   score = sum over i = 0..15 in that order of (brighter_i | darker_i ?
//     |c_i - p| : 0) at corners, 0 elsewhere (written to `score`);
//   survivor = score > 0, score >= each of its 8 neighbours that lie inside
//     the level (outside counts as -inf: the suppression window does not
//     wrap), and edge <= y < h - edge, edge <= x < w - edge;
//   masked = survivor ? score : -1 (written to `masked`), and the level's
//     count of survivors at t0 (integer atomics: the total is the same in
//     any order).
// The sum runs in circle order, as the plain version's, so the scores are
// the same bits at every level.
//
// What bounds it on an H100: bytes. A 640x480 frame's 8 levels hold ~1.0M
// pixels; the kernel reads each once (4 B) and writes two score and two
// masked maps (16 B), ~20 MB, ~6 us at 3.35 TB/s; the ~190 float ops per
// pixel take ~3 us at 67 TFLOP/s.
//
// Design: one CTA of 256 threads per 32x16 tile of a level, every level's
// tiles in one grid (a level table passed by value). The CTA loads the
// tile with a 4-pixel halo (3 for the circle, 1 for the suppression) into
// shared memory, indices taken modulo the level size; computes both
// scores on the tile plus a 1-pixel ring into shared memory; then
// suppresses and writes. Built with --fmad=false (nothing here contracts,
// but the scores must stay the plain version's bits).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kTW = 32;
constexpr int kTH = 16;
constexpr int kThreads = 256;
constexpr int kPW = kTW + 8;  // pixel tile with a 4-pixel halo
constexpr int kPH = kTH + 8;
constexpr int kSW = kTW + 2;  // score tile with a 1-pixel ring
constexpr int kSH = kTH + 2;

__constant__ int kCircleX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleY[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                 3, 3, 2, 1, 0, -1, -2, -3};

struct FastLevels {
  const float* img[kMaxLevels];
  float* score[kMaxLevels];   // (2, h, w)
  float* masked[kMaxLevels];  // (2, h, w)
  int h[kMaxLevels];
  int w[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tile_start[kMaxLevels + 1];
  int n;
};

__device__ __forceinline__ int wrap(int i, int n) {
  const int r = i % n;
  return r < 0 ? r + n : r;
}

// nine consecutive set bits among 16, wrapping around
__device__ __forceinline__ bool has_run9(unsigned bits) {
  const unsigned m32 = bits | (bits << 16);
  unsigned run = m32;
  for (int s = 1; s < 9; ++s) run &= m32 >> s;
  return (run & 0xFFFFu) != 0u;
}

__global__ void __launch_bounds__(kThreads)
orb_fast_kernel(FastLevels L, int* __restrict__ counts, float t0, float t1,
                int edge) {
  __shared__ float pix[kPH * kPW];
  __shared__ float sc[2][kSH * kSW];
  __shared__ int n_kept;

  int lvl = 0;
  while (lvl + 1 < L.n && (int)blockIdx.x >= L.tile_start[lvl + 1]) ++lvl;
  const int tile = (int)blockIdx.x - L.tile_start[lvl];
  const int h = L.h[lvl], w = L.w[lvl];
  const int y0 = (tile / L.tiles_x[lvl]) * kTH;
  const int x0 = (tile % L.tiles_x[lvl]) * kTW;
  const float* __restrict__ img = L.img[lvl];
  const int tid = threadIdx.x;
  if (tid == 0) n_kept = 0;

  for (int i = tid; i < kPH * kPW; i += kThreads) {
    const int gy = wrap(y0 - 4 + i / kPW, h);
    const int gx = wrap(x0 - 4 + i % kPW, w);
    pix[i] = img[(size_t)gy * w + gx];
  }
  __syncthreads();

  const size_t plane = (size_t)h * w;
  for (int i = tid; i < kSH * kSW; i += kThreads) {
    const int sy = i / kSW, sx = i % kSW;
    const float* c = pix + (sy + 3) * kPW + (sx + 3);
    const float p = c[0];
    float q[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) q[k] = c[kCircleY[k] * kPW + kCircleX[k]];
    const int gy = y0 - 1 + sy, gx = x0 - 1 + sx;
    const bool inner = sy >= 1 && sy <= kTH && sx >= 1 && sx <= kTW &&
                       gy < h && gx < w;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float thr = t == 0 ? t0 : t1;
      const float hi = p + thr, lo = p - thr;
      unsigned bright = 0u, dark = 0u;
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 16; ++k) {
        const bool b = q[k] > hi, d = q[k] < lo;
        bright |= (unsigned)b << k;
        dark |= (unsigned)d << k;
        const float term = (b || d) ? fabsf(q[k] - p) : 0.f;
        s = k == 0 ? term : s + term;
      }
      s = (has_run9(bright) || has_run9(dark)) ? s : 0.f;
      sc[t][i] = s;
      if (inner) L.score[lvl][t * plane + (size_t)gy * w + gx] = s;
    }
  }
  __syncthreads();

  int kept = 0;
  for (int i = tid; i < kTH * kTW; i += kThreads) {
    const int oy = i / kTW, ox = i % kTW;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= h || gx >= w) continue;
    const bool inb = gy >= edge && gy < h - edge && gx >= edge &&
                     gx < w - edge;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float s = sc[t][(oy + 1) * kSW + ox + 1];
      bool m = inb && s > 0.f;
      for (int dy = -1; dy <= 1; ++dy) {
        for (int dx = -1; dx <= 1; ++dx) {
          const int ny = gy + dy, nx = gx + dx;
          if ((dy == 0 && dx == 0) || ny < 0 || ny >= h || nx < 0 || nx >= w)
            continue;
          m = m && s >= sc[t][(oy + 1 + dy) * kSW + ox + 1 + dx];
        }
      }
      L.masked[lvl][t * plane + (size_t)gy * w + gx] = m ? s : -1.f;
      if (t == 0 && m) ++kept;
    }
  }
  if (kept) atomicAdd(&n_kept, kept);
  __syncthreads();
  if (tid == 0 && n_kept) atomicAdd(counts + lvl, n_kept);
}

}  // namespace

// img, score, masked: host arrays of n device pointers (level images (h, w),
// outputs (2, h, w)); h, w: host arrays of n sizes; counts: (n,) int32 on
// the device, zeroed by the caller.
extern "C" int orb_fast(const void* const* img, void* const* score,
                        void* const* masked, const int* h, const int* w, int n,
                        int* counts, float t0, float t1, int edge,
                        void* stream) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  FastLevels L{};
  L.n = n;
  int tiles = 0;
  for (int l = 0; l < n; ++l) {
    if (h[l] < 1 || w[l] < 1) return (int)cudaErrorInvalidValue;
    L.img[l] = static_cast<const float*>(img[l]);
    L.score[l] = static_cast<float*>(score[l]);
    L.masked[l] = static_cast<float*>(masked[l]);
    L.h[l] = h[l];
    L.w[l] = w[l];
    L.tiles_x[l] = (w[l] + kTW - 1) / kTW;
    L.tile_start[l] = tiles;
    tiles += L.tiles_x[l] * ((h[l] + kTH - 1) / kTH);
  }
  L.tile_start[n] = tiles;
  orb_fast_kernel<<<tiles, kThreads, 0, (cudaStream_t)stream>>>(L, counts, t0,
                                                                t1, edge);
  return (int)cudaGetLastError();
}
