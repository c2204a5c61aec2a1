// Orientation, the 7x7 blur at the samples and rotated BRIEF at the ORB
// keypoints of every pyramid level, in one launch from the level images.
//
// Replaces orientation_maps, blur7 and the gathers of describe in
// xfeatslam_tpu/models/orb.py orb_describe_all (:148-204, :274-289), which
// is XLA code in the JAX package, not Pallas. There, and in the PyTorch
// counterpart (ops/cuda_kernels.orb_describe_plain), the intensity-centroid
// moments m10 and m01 are two 31x31 convolutions and the blur a 7x7 one
// over every pixel of every level, of which ~1,000 keypoints read a few
// hundred pixels each; this kernel computes them at the keypoints only.
//
// What it computes, as the plain version does, for keypoint k of a level
// (h, w):
//   (xi, yi) = the keypoint's (x, y) truncated to int and clamped to the
//     level;
//   m10 = sum of dx * lvl[yi + dy, xi + dx], m01 = sum of dy * lvl[...]
//     over the disc dx^2 + dy^2 <= 15^2, pixels outside the level 0 (the
//     convolutions' zero padding);
//   angle = atan2(m01, m10), ca = cos(angle), sa = sin(angle);
//   for each of the 256 pattern pairs (x1, y1, x2, y2): a point (px, py)
//     goes to (gx, gy) = (xi + round(ca px - sa py), yi + round(sa px +
//     ca py)), rounded half to even as torch.round, clamped to the level;
//     its value is the 7x7 Gaussian (the float32 weights w of
//     models/orb._gauss_kernel7) at (gx, gy), pixels outside the level 0,
//     summed in float64 and rounded once to float32 (the plain version's
//     blur7: a float64 convolution rounded to float32); bit = v1 < v2,
//     written as float 0/1 times the keypoint's valid flag; the angle is
//     written for every slot.
// The moments are summed in double: at level 0 (integer pixels, |m| <
// 2^24) any order gives the plain version's float32 value exactly, and
// above it the sum is the exact sum rounded once (the plain version's
// float32 convolution differs by its rounding). The rotation is computed
// with the plain version's float operations in its order (--fmad=false).
//
// The bits without a float64 blur at every sample. A bit needs only the
// order of two blurred values. So the kernel first blurs in float32, as
// two 1-D passes of the weights' separable factors g: the horizontal pass
// over the patch, the vertical 7 taps at each sample (g_x g_y lies within
// delta of w_xy, relatively, a few float32 ulps; the host measures
// delta). For pixels >= 0 every term is >= 0, so such a value s lies
// within kappa s of the exact sum S (kappa = 2 (delta + 16 u), u = 2^-24:
// the two 7-term passes round 14 times). A pair whose gap is wider than
// the error of both plus one float32 ulp of the larger value is decided
// from these: the exact sums, and their float32 roundings strictly, are
// in the same order. The other pairs (few on a rendered frame, nearly all
// exact ties: both samples on one flat patch) are decided from the
// float64 blur of both samples, the plain version's value; so are all
// pairs of a patch with a pixel whose sign bit is set, a point beyond the
// reach (another pattern) and weights that do not factor (kappa >=
// 2^-10). So the bits are those of the float64 blur at every sample.
//
// What bounds it on an H100: the latency of each slot's chain of phases
// (the slot's position, its patch from L2, the passes and the moments,
// the bits), 2,000 slots deep at eight CTAs an SM, more than its work.
// Per valid keypoint it reads the patch (1,849 pixels of the level) and
// writes 1 KB of bits; the horizontal pass is ~11,000 float32
// multiply-adds, the samples' vertical taps ~3,600.
//
// Design: one CTA of four warps per keypoint slot (every level's slots in
// one grid; the level found from the level table's slot starts by seven
// compares). A padding slot (valid false) writes zero bits, its warps sum
// eight disc rows each from the level and thread 0 takes the angle. A
// valid slot copies the 43x43 patch around (xi, yi) (radius 21: the reach
// 18, which the rotated pattern's 13 sqrt 2 needs, plus the blur's 3; zero
// outside the level) into shared memory as floats, a warp a row, every
// load in flight at once. Then warps 0-2 run the horizontal pass, a thread
// per patch row and half of the 37 centre columns (19 outputs from 25
// loads; the rows' pitch is odd so a warp's rows fall in different banks),
// while warp 3 sums the moments (lanes along x, one per dx, over the 31
// disc rows, in double, four interleaved sums, then a fixed-order shuffle
// tree) and takes the angle. Each thread then rotates its two pairs'
// points, sums each sample's vertical taps and decides the bits.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kWarps = 4;     // a keypoint slot's warps
constexpr int kThreads = 32 * kWarps;
constexpr int kRadius = 15;   // the orientation disc
constexpr int kDisc = 2 * kRadius + 1;
constexpr int kBits = 256;
constexpr int kReach = 18;    // |round(r)| of a rotated point within 13
constexpr int kPatchR = kReach + 3;
constexpr int kPS = 2 * kPatchR + 1;  // 43: the patch's rows, columns, pitch
constexpr int kBS = 2 * kReach + 1;   // 37: the blurred centres a row
constexpr int kHOut = 19;     // the horizontal pass's outputs a thread

struct DescLevels {
  const float* img[kMaxLevels];    // (h, w) level image
  const float* kpts[kMaxLevels];   // (n, 2) (x, y) level coordinates
  const bool* valid[kMaxLevels];   // (n,)
  float* desc[kMaxLevels];         // (n, 256)
  float* angle[kMaxLevels];        // (n,)
  int h[kMaxLevels];
  int w[kMaxLevels];
  int kp_start[kMaxLevels + 1];
  int n;
  double gauss[49];                // the blur's weights, row-major
  float g[7];                      // their separable factors
  float kappa;                     // the float32 passes' relative error
                                   // bound (with room for the decision's
                                   // own rounding), or 0: none
};

// shared memory: the slot's patch; the horizontal pass's rows (43 x 37:
// patch row r, centre column c); a padding slot's moment sums a warp; cos
// and sin of the angle
struct Smem {
  float patch[kPS * kPS];
  float hb[kPS * kBS];
  double part[kWarps][2];
  float rot[2];
};

__device__ __forceinline__ double warp_sum(double v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the float64 blur of two points of the patch (centres at0, at1), each
// row's seven products summed left to right (seven independent sums),
// then the rows top to bottom; rounded once to float32
__device__ __noinline__ float2 blur_patch2(const DescLevels& L,
                                           const float* patch, int at0,
                                           int at1) {
  double r0[7], r1[7];
#pragma unroll
  for (int dy = 0; dy < 7; ++dy) {
    const float* p0 = patch + at0 + (dy - 3) * kPS - 3;
    const float* p1 = patch + at1 + (dy - 3) * kPS - 3;
    r0[dy] = __dmul_rn(L.gauss[dy * 7], (double)p0[0]);
    r1[dy] = __dmul_rn(L.gauss[dy * 7], (double)p1[0]);
#pragma unroll
    for (int dx = 1; dx < 7; ++dx) {
      r0[dy] = __fma_rn(L.gauss[dy * 7 + dx], (double)p0[dx], r0[dy]);
      r1[dy] = __fma_rn(L.gauss[dy * 7 + dx], (double)p1[dx], r1[dy]);
    }
  }
  double s0 = r0[0], s1 = r1[0];
#pragma unroll
  for (int dy = 1; dy < 7; ++dy) {
    s0 = __dadd_rn(s0, r0[dy]);
    s1 = __dadd_rn(s1, r1[dy]);
  }
  return make_float2(__double2float_rn(s0), __double2float_rn(s1));
}

// the same blur of one point read from the level (zero outside it), for a
// pair with a point beyond the patch (another pattern)
__device__ __noinline__ float blur_level(const DescLevels& L,
                                         const float* img, int h, int w,
                                         int gx, int gy) {
  double s = 0.0;
  for (int dy = 0; dy < 7; ++dy) {
    double row = 0.0;
    for (int dx = 0; dx < 7; ++dx) {
      const int y = gy + dy - 3, x = gx + dx - 3;
      const double v = (y >= 0 && y < h && x >= 0 && x < w)
                           ? (double)img[(size_t)y * w + x]
                           : 0.0;
      row = dx == 0 ? __dmul_rn(L.gauss[dy * 7], v)
                    : __fma_rn(L.gauss[dy * 7 + dx], v, row);
    }
    s = dy == 0 ? row : __dadd_rn(s, row);
  }
  return __double2float_rn(s);
}

// n outputs of a 7-tap float32 pass from n + 6 inputs at stride `in`, to
// stride `out`, the first `skip` not written
template <int N>
__device__ __forceinline__ void pass(const float* g, const float* src,
                                     int in, float* dst, int out,
                                     int skip) {
  float v[N + 6];
#pragma unroll
  for (int j = 0; j < N + 6; ++j) v[j] = src[j * in];
#pragma unroll
  for (int j = 0; j < N; ++j) {
    float a = v[j] * g[0];
#pragma unroll
    for (int d = 1; d < 7; ++d) a = __fmaf_rn(g[d], v[j + d], a);
    if (j >= skip) dst[j * out] = a;
  }
}

// the moments over disc rows dy0 .. dy0 + n - 1 (at most 15) at (xi, yi),
// lane dx + 15 summing its column (from the patch, or for a padding slot
// from the level; the same values) in double, as four interleaved sums
// added in order, then a fixed-order shuffle tree; (m10, m01) to every
// lane
template <int N>
__device__ __forceinline__ void disc_moments(const float* patch,
                                             const float* img, int h, int w,
                                             int xi, int yi, bool from_patch,
                                             int lane, int dy0, double& m10,
                                             double& m01) {
  const int dx = lane - kRadius, x = xi + dx;
  const bool col = lane < kDisc && x >= 0 && x < w;
  double sum[4] = {0.0, 0.0, 0.0, 0.0}, s01[4] = {0.0, 0.0, 0.0, 0.0};
#pragma unroll
  for (int j = 0; j < N; ++j) {
    const int dy = dy0 + j, y = yi + dy;
    const bool in = dy <= kRadius && col &&
                    dx * dx + dy * dy <= kRadius * kRadius && y >= 0 &&
                    y < h;
    const double v =
        !in          ? 0.0
        : from_patch ? (double)patch[(dy + kPatchR) * kPS + dx + kPatchR]
                     : (double)img[(size_t)y * w + x];
    sum[j % 4] += v;
    s01[j % 4] += (double)dy * v;
  }
  m10 = warp_sum((double)dx * (((sum[0] + sum[1]) + sum[2]) + sum[3]));
  m01 = warp_sum(((s01[0] + s01[1]) + s01[2]) + s01[3]);
}

__global__ void __launch_bounds__(kThreads, 8)
orb_describe_kernel(const __grid_constant__ DescLevels L,
                    const float4* __restrict__ pattern) {
  __shared__ Smem S;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int gid = (int)blockIdx.x;
  int lvl = 0;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l)
    lvl += (l < L.n && gid >= L.kp_start[l]) ? 1 : 0;
  const int k = gid - L.kp_start[lvl];
  const int h = L.h[lvl], w = L.w[lvl];
  const float* __restrict__ img = L.img[lvl];
  const int xi = min(max((int)L.kpts[lvl][2 * k], 0), w - 1);
  const int yi = min(max((int)L.kpts[lvl][2 * k + 1], 0), h - 1);
  const bool valid = L.valid[lvl][k];
  float* __restrict__ out = L.desc[lvl] + (size_t)k * kBits;

  if (!valid) {
    // a padding slot: warp r sums disc rows 8r - 15 .., the warps' sums
    // added in order
    out[tid] = 0.f;
    out[tid + kThreads] = 0.f;
    double m10, m01;
    disc_moments<8>(nullptr, img, h, w, xi, yi, false, lane,
                    8 * warp - kRadius, m10, m01);
    if (lane == 0) {
      S.part[warp][0] = m10;
      S.part[warp][1] = m01;
    }
    __syncthreads();
    if (tid == 0) {
#pragma unroll
      for (int r = 1; r < kWarps; ++r) {
        m10 += S.part[r][0];
        m01 += S.part[r][1];
      }
      L.angle[lvl][k] = atan2f((float)m01, (float)m10);
    }
    return;
  }

  // this thread's pairs, tid and tid + 128, in flight with the patch
  const float4 pair[2] = {pattern[tid], pattern[tid + kThreads]};
  // the patch around (xi, yi), zero outside the level: warp r copies rows
  // r, r + 4, ..., lane l columns l and l + 32, every load in flight at
  // once; the OR of their bits
  unsigned signs = 0;
  {
    constexpr int kRows = (kPS + kWarps - 1) / kWarps;
    const int xa = xi - kPatchR + lane, xb = xa + 32;
    const bool ina = xa >= 0 && xa < w;
    const bool inb = lane + 32 < kPS && xb >= 0 && xb < w;
    float va[kRows], vb[kRows];
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = warp + kWarps * j, y = yi - kPatchR + r;
      const bool iny = r < kPS && y >= 0 && y < h;
      const float* row = img + (size_t)y * w;
      va[j] = iny && ina ? row[xa] : 0.f;
      vb[j] = iny && inb ? row[xb] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kRows; ++j) {
      const int r = warp + kWarps * j;
      if (r < kPS) {
        S.patch[r * kPS + lane] = va[j];
        if (lane + 32 < kPS) S.patch[r * kPS + lane + 32] = vb[j];
      }
      signs |= __float_as_uint(va[j]) | __float_as_uint(vb[j]);
    }
  }
  // a pixel with its sign bit set (negative, or -0) takes the float64
  // blur for every pair
  const bool exact_only = __syncthreads_or(signs >> 31) || L.kappa == 0.f;

  // warps 0-2: the horizontal pass, thread i < 86 taking patch row i % 43
  // and half i / 43 of the centre columns (0-18, 19-36: the second
  // computes from column 18 and does not write it); warp 3: the moments
  // over the whole disc, the angle
  if (warp < kWarps - 1) {
    if (tid < 2 * kPS) {
      const int r = tid % kPS, c0 = (tid / kPS) * (kHOut - 1);
      pass<kHOut>(L.g, S.patch + r * kPS + c0, 1, S.hb + r * kBS + c0, 1,
                  c0 > 0 ? 1 : 0);
    }
  } else {
    double m10, m01;
    disc_moments<kDisc>(S.patch, img, h, w, xi, yi, true, lane, -kRadius,
                        m10, m01);
    if (lane == 0) {
      const float a = atan2f((float)m01, (float)m10);
      L.angle[lvl][k] = a;
      S.rot[0] = cosf(a);
      S.rot[1] = sinf(a);
    }
  }
  __syncthreads();
  // the bits of this thread's two pairs
  const float ca = S.rot[0], sa = S.rot[1];
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float px[2] = {pair[j].x, pair[j].z};
    const float py[2] = {pair[j].y, pair[j].w};
    int ox[2], oy[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float rx = ca * px[e] - sa * py[e];
      const float ry = sa * px[e] + ca * py[e];
      ox[e] = min(max(xi + (int)rintf(rx), 0), w - 1) - xi;
      oy[e] = min(max(yi + (int)rintf(ry), 0), h - 1) - yi;
    }
    bool bit = false;
    if (ox[0] != ox[1] || oy[0] != oy[1]) {
      const bool near0 = abs(ox[0]) <= kReach && abs(oy[0]) <= kReach;
      const bool near1 = abs(ox[1]) <= kReach && abs(oy[1]) <= kReach;
      int decided = -1;
      if (near0 && near1 && !exact_only) {
        // each sample's vertical pass: 7 taps down the horizontal pass's
        // column
        float sv[2];
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const float* c = S.hb + (oy[e] + kReach) * kBS + ox[e] + kReach;
          float a = c[0] * L.g[0];
#pragma unroll
          for (int d = 1; d < 7; ++d) a = __fmaf_rn(L.g[d], c[d * kBS], a);
          sv[e] = a;
        }
        const float s1 = sv[0], s2 = sv[1];
        const float gap = s2 - s1;
        const float m =
            L.kappa * (s1 + s2) + 0x1p-21f * fmaxf(s1, s2) + 0x1p-100f;
        decided = gap > m ? 1 : gap < -m ? 0 : -1;
      }
      if (decided >= 0) {
        bit = decided;
      } else {
        float v[2];
        if (near0 && near1) {
          const float2 b2 = blur_patch2(
              L, S.patch, (oy[0] + kPatchR) * kPS + ox[0] + kPatchR,
              (oy[1] + kPatchR) * kPS + ox[1] + kPatchR);
          v[0] = b2.x;
          v[1] = b2.y;
        } else {
#pragma unroll
          for (int e = 0; e < 2; ++e)
            v[e] = blur_level(L, img, h, w, xi + ox[e], yi + oy[e]);
        }
        bit = v[0] < v[1];
      }
    }
    out[tid + kThreads * j] = bit ? 1.f : 0.f;
  }
}

}  // namespace

// img, kpts, valid, desc, angle: host arrays of n device pointers; h, w,
// count: host arrays of n level sizes and keypoint slots; pattern: the 256
// pairs (x1, y1, x2, y2), float32 on the device; gauss: the blur's 49
// weights, a host array.
extern "C" int orb_describe(const void* const* img, const void* const* kpts,
                            const void* const* valid, void* const* desc,
                            void* const* angle, const int* h, const int* w,
                            const int* count, int n, const float* pattern,
                            const float* gauss, void* stream) {
  if (n < 1 || n > kMaxLevels) return (int)cudaErrorInvalidValue;
  DescLevels L{};
  L.n = n;
  int slots = 0;
  for (int l = 0; l < n; ++l) {
    if (h[l] < 1 || w[l] < 1 || count[l] < 0)
      return (int)cudaErrorInvalidValue;
    L.img[l] = static_cast<const float*>(img[l]);
    L.kpts[l] = static_cast<const float*>(kpts[l]);
    L.valid[l] = static_cast<const bool*>(valid[l]);
    L.desc[l] = static_cast<float*>(desc[l]);
    L.angle[l] = static_cast<float*>(angle[l]);
    L.h[l] = h[l];
    L.w[l] = w[l];
    L.kp_start[l] = slots;
    slots += count[l];
  }
  for (int l = n; l <= kMaxLevels; ++l) L.kp_start[l] = slots;
  for (int i = 0; i < 49; ++i) L.gauss[i] = (double)gauss[i];
  // the weights' separable factors g_x = sqrt(w_xx) rounded to float32,
  // and how far g_x g_y lies from w_xy, relatively (delta); weights that
  // are not all positive and finite, or do not factor, take the float64
  // blur only. kappa is raised by a quarter for the decision's float32
  // arithmetic.
  bool positive = true;
  for (int i = 0; i < 49; ++i)
    positive = positive && gauss[i] > 0.f && gauss[i] < INFINITY;
  double delta = 1.0;
  if (positive) {
    delta = 0.0;
    for (int i = 0; i < 7; ++i) L.g[i] = (float)sqrt(L.gauss[i * 8]);
    for (int y = 0; y < 7; ++y)
      for (int x = 0; x < 7; ++x)
        delta = fmax(delta, fabs((double)L.g[y] * (double)L.g[x] /
                                     L.gauss[y * 7 + x] - 1.0));
  }
  const double kappa = 2.0 * (delta + 16.0 * 0x1p-24);
  L.kappa = kappa < 0x1p-10 ? (float)(1.25 * kappa) : 0.f;
  if (slots == 0) return (int)cudaSuccess;
  orb_describe_kernel<<<slots, kThreads, 0, (cudaStream_t)stream>>>(
      L, reinterpret_cast<const float4*>(pattern));
  return (int)cudaGetLastError();
}
