// The ORB pyramid, FAST-9 at two thresholds, 3x3 non-maximum suppression
// and the border mask of every level, in one launch from the level-0 image.
//
// Replaces the pyramid resize and, per level, fast_score_map + nms3_mask +
// the EDGE mask of xfeatslam_tpu/models/orb.py orb_candidates (:93-131,
// :206-250), which is XLA code in the JAX package, not Pallas. Its PyTorch
// counterpart (ops/cuda_kernels.orb_fast_plain) resizes each level with
// ops/image.resize_bilinear (a kernel a tap per level and axis), then
// builds the 16 circle pixels as one stacked tensor and runs ~20
// elementwise kernels per threshold and level; this kernel reads the
// level-0 image and writes each level once.
//
// What it computes, as the plain version does:
//   each level l >= 1 of size (h, w) as resize_bilinear(img0, (h, w)): one
//     axis after the other (H first where h_first[l], else W first), each
//     output a chain over its taps in input order: acc = float32(w0 * x0),
//     then acc = float32(double(acc) + double(w_t) * double(x_t)) for each
//     further tap (the product of two float32 values is exact in double,
//     so this is one float64 sum rounded once to float32, as
//     torch.add(prod, acc, out=acc) computes it); the taps are
//     ops/image._taps' nonzero ones (its zero-weight padding leaves the
//     sum as it is), the intermediate is float32; level 0 is the image;
//   for each pixel p of a level and each threshold t (t0 = the initial,
//   t1 = the minimum threshold):
//     circle pixel c_i = lvl[(y + dy_i) mod h, (x + dx_i) mod w] (the image
//       wraps around, as jnp.roll does in the JAX package);
//     brighter_i = c_i > p + t, darker_i = c_i < p - t;
//     a corner where nine consecutive circle pixels (with wrap-around) are
//       all brighter or all darker;
//     score = sum over i = 0..15 in that order of (brighter_i | darker_i ?
//       |c_i - p| : 0) at corners, 0 elsewhere (written to `score`);
//     survivor = score > 0, score >= each of its 8 neighbours that lie
//       inside the level (outside counts as -inf: the suppression window
//       does not wrap), and edge <= y < h - edge, edge <= x < w - edge;
//     masked = survivor ? score : -1 (written to `masked`), and the level's
//       count of survivors at t0.
// The level images are written to one flat buffer (level after level,
// each (h, w)), which the describe stage reads.
//
// What bounds it on an H100: bytes. A 640x480 frame's 8 levels hold ~1.0M
// pixels; the kernel reads the 1.2 MB image once and writes each level
// pixel (4 B) and two score and two masked maps (16 B), ~21 MB, ~6.3 us
// at 3.35 TB/s. Its operations: per pixel ~230 float ops for FAST and the
// suppression, and per level pixel the resize's taps (3-8 per axis and
// output), each a float64 multiply-add and a rounding to float32 (below).
//
// Design: one CTA of 256 threads per 32x16 output tile of a level (of
// 32x16, 64x16 and 64x32 the fastest by measurement; PERF.md), every
// level's tiles in one grid; a CTA finds its level from the level
// table's tile starts by seven compares. The tile with a 4-pixel halo (3
// for the circle, 1 for the suppression) is built in shared memory: its
// rows and columns are level indices taken modulo the level size, each
// found once per row or column by compares. At level 0 the halo tile is
// copied from the image by cp.async. Above it, the CTA reads the halo
// rows' and columns' taps (first input index, count, and the weights as
// doubles, transposed so that neighbouring threads read neighbouring
// weights) and copies by cp.async, in one round trip, the image region
// that they cover: its rows and columns are indexed in an unwrapped input
// space in which level index x + k w maps to input index i + k n_in, so
// the region of a tile whose halo wraps stays contiguous, and each of its
// pixels is read at its wrapped index; the host sizes the region per
// level (ops/cuda_kernels.orb_fast_tables). The first axis
// runs over the region into a float32 intermediate after it, the second
// into the halo tile, each thread four outputs at once (independent
// chains). A tap's rounding to float32 stays in double: adding and
// subtracting 1.5 * 2^(E + 29) rounds to float32's spacing (round_float),
// without the two conversions, which the card runs at a quarter of its
// float64 rate. Then FAST at both thresholds on the tile plus a 1-pixel
// ring (the ring's scores in the shared memory that held the region):
// the four compass pixels first, at the lower threshold, since a run of
// nine holds two neighbouring ones (most pixels of a camera frame fail
// this and score 0 at once), then the 16 circle loads once for both
// thresholds. The suppression writes the level pixels, the scores
// and the masked maps of the tile, and counts the survivors by a warp
// reduction and one integer atomic per CTA (the total is the same in any
// order). Threads walk the halo tile and the ring along rows, so a warp's
// circle reads are 32 consecutive words. Built with --fmad=false (the
// resize's double products are exact and the FAST sums have nothing to
// contract, but the scores must stay the plain version's bits).

#include <cuda_runtime.h>

namespace {

constexpr int kMaxLevels = 8;
constexpr int kThreads = 256;
constexpr int kHalo = 4;  // 3 for the circle, 1 for the suppression
constexpr int kMaxTaps = 16;
constexpr int kIlp = 4;  // resize outputs a thread computes at once

__constant__ int kCircleX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                                 0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int kCircleY[16] = {-3, -3, -2, -1, 0, 1, 2, 3,
                                 3, 3, 2, 1, 0, -1, -2, -3};

// one axis of a level's resize: output j reads inputs start[j] ..
// start[j] + count[j] - 1 with weights weight[j * taps + t]
struct Axis {
  const int* start;
  const int* count;
  const float* weight;
  int taps;
};

struct FastLevels {
  float* level[kMaxLevels];   // (h, w) in the flat level buffer
  float* score[kMaxLevels];   // (2, h, w)
  float* masked[kMaxLevels];  // (2, h, w)
  Axis rows[kMaxLevels];      // the H axis (levels >= 1)
  Axis cols[kMaxLevels];      // the W axis (levels >= 1)
  int h[kMaxLevels];
  int w[kMaxLevels];
  int h_first[kMaxLevels];
  int tiles_x[kMaxLevels];
  int tile_start[kMaxLevels + 1];
  int n;
};

// i mod n for i within a few n of [0, n), and the number of wraps
__device__ __forceinline__ int wrap(int i, int n, int* k) {
  int q = 0;
  while (i < 0) { i += n; --q; }
  while (i >= n) { i -= n; ++q; }
  *k = q;
  return i;
}

// nine consecutive set bits among 16, wrapping around: runs of 2, 4, 8
// and 9 starting at each bit of the doubled mask
__device__ __forceinline__ bool has_run9(unsigned bits) {
  const unsigned m = bits | (bits << 16);
  const unsigned r2 = m & (m >> 1);
  const unsigned r4 = r2 & (r2 >> 2);
  const unsigned r8 = r4 & (r4 >> 4);
  return ((r8 & (m >> 8)) & 0xFFFFu) != 0u;
}

// s rounded to float32's precision (to nearest, ties to even), as a
// double: adding c = 1.5 * 2^(E + 29), E the exponent of s, rounds s to a
// multiple of 2^(E - 23), float32's spacing in s's binade, and subtracting
// c again is exact. The same value as double(float(s)) without the two
// conversions, which the card runs at a quarter of its float64 rate; below
// float32's normal range (|s| < 2^-126, not 0) the spacing differs, and
// such an s takes the conversions.
__device__ __forceinline__ double round_float(double s) {
  const int e = __double2hiint(s) & 0x7ff00000;
  if (e < 0x38100000 && s != 0.0) return (double)__double2float_rn(s);
  const double c = __hiloint2double(e + 0x01d80000, 0);
  return __dsub_rn(__dadd_rn(s, c), c);
}

// the first tap: its exact product rounded to float32
__device__ __forceinline__ double tap0(double w, float x) {
  return round_float(__dmul_rn(w, (double)x));
}

// a 4-byte asynchronous copy from global to shared memory
__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::);
}

// a further tap: the float64 sum of the exact product and the accumulator
// (a float32 value), rounded once to float32
__device__ __forceinline__ double tap(double acc, double w, float x) {
  return round_float(__fma_rn(w, (double)x, acc));
}

// kIlp outputs of one resize axis at once: output q has n[q] taps (0: none,
// its sum unused), tap t at x[q][t * xs] with weight w[q][t * ws]. The
// chains are independent, so their latencies overlap.
__device__ __forceinline__ void tap_chains(const float* const* x, int xs,
                                           const double* const* w, int ws,
                                           const int* n, double* acc) {
  int most = 1;
#pragma unroll
  for (int q = 0; q < kIlp; ++q) {
    acc[q] = tap0(w[q][0], x[q][0]);
    most = max(most, n[q]);
  }
  for (int t = 1; t < most; ++t) {
#pragma unroll
    for (int q = 0; q < kIlp; ++q)
      if (t < n[q]) acc[q] = tap(acc[q], w[q][t * ws], x[q][t * xs]);
  }
}

constexpr int TW = 32, TH = 16;     // the output tile
constexpr int PH = TH + 2 * kHalo;  // halo tile rows
constexpr int PW = TW + 2 * kHalo;  // halo tile columns
constexpr int SH = TH + 2;          // score tile with a 1-pixel ring
constexpr int SW = TW + 2;

// dynamic shared memory: row and column tap weights (doubles, [t][r] and
// [t][c]), six int arrays, eight ints, then the halo tile and the work
// area (the resize's input region and intermediate, then the ring's
// scores)
constexpr size_t smem_bytes(int taps, int work_floats) {
  return sizeof(double) * (size_t)(PH + PW) * taps +
         sizeof(int) * (size_t)(3 * (PH + PW) + 8) +
         sizeof(float) * (size_t)(PH * PW + work_floats);
}

__global__ void __launch_bounds__(kThreads)
orb_fast_kernel(FastLevels L, const float* __restrict__ img0, int H0, int W0,
                int* __restrict__ counts, float t0, float t1, int edge,
                int taps_max, int work_floats) {
  extern __shared__ __align__(16) unsigned char smem[];
  double* rw = reinterpret_cast<double*>(smem);  // [t][PH]
  double* cw = rw + PH * taps_max;                // [t][PW]
  int* ry = reinterpret_cast<int*>(cw + PW * taps_max);  // wrapped row
  int* rsu = ry + PH;   // its taps' first input row, unwrapped
  int* rcn = rsu + PH;  // its taps
  int* cx = rcn + PH;   // the same for the columns
  int* csu = cx + PW;
  int* ccn = csu + PW;
  int* misc = ccn + PW;  // the row and column spans, survivors
  float* pix = reinterpret_cast<float*>(misc + 8);  // [PH][PW]
  float* work = pix + PH * PW;

  const int bid = (int)blockIdx.x;
  int lvl = 0;
#pragma unroll
  for (int l = 1; l < kMaxLevels; ++l)
    lvl += (l < L.n && bid >= L.tile_start[l]) ? 1 : 0;
  const int tile = bid - L.tile_start[lvl];
  const int h = L.h[lvl], w = L.w[lvl];
  const int tiles_x = L.tiles_x[lvl];
  const int y0 = (tile / tiles_x) * TH;
  const int x0 = (tile % tiles_x) * TW;
  const bool h_first = L.h_first[lvl] != 0;
  const int tid = threadIdx.x;
  const int warp = tid / 32, lane = tid % 32;
  const int nw = kThreads / 32;

  if (tid == 0) {
    misc[0] = misc[2] = 0x7fffffff;  // the spans' first rows and columns
    misc[1] = misc[3] = -0x7fffffff;  // and last ones
    misc[4] = 0;                      // survivors
  }
  __syncthreads();
  // the halo rows' and columns' level indices and, above level 0, their
  // first taps in the unwrapped input space and their tap counts
  const Axis ra = L.rows[lvl], ca = L.cols[lvl];
  for (int i = tid; i < PH + PW; i += kThreads) {
    const bool row = i < PH;
    const int j = row ? i : i - PH;
    int k;
    const int at = wrap((row ? y0 : x0) - kHalo + j, row ? h : w, &k);
    (row ? ry : cx)[j] = at;
    if (lvl > 0) {
      const Axis& ax = row ? ra : ca;
      const int su = ax.start[at] + k * (row ? H0 : W0), n = ax.count[at];
      (row ? rsu : csu)[j] = su;
      (row ? rcn : ccn)[j] = n;
      atomicMin(&misc[row ? 0 : 2], su);
      atomicMax(&misc[row ? 1 : 3], su + n - 1);
    }
  }
  __syncthreads();

  if (lvl == 0) {
    for (int i = tid; i < PH * PW; i += kThreads)
      cp_async4(pix + i, img0 + (size_t)ry[i / PW] * W0 + cx[i % PW]);
    cp_async_wait_all();
  } else {
    // the input region that the taps cover, rows [rlo, rlo + nr) and
    // columns [clo, clo + nc) of the unwrapped input space, read at
    // their wrapped indices; then the intermediate after it
    const int rlo = misc[0], nr = misc[1] - rlo + 1;
    const int clo = misc[2], nc = misc[3] - clo + 1;
    float* region = work;
    float* tmp = work + nr * nc;
    if (nr * nc + (h_first ? PH * nc : nr * PW) > work_floats)
      __trap();  // the host sized the spans
    for (int v = warp; v < nr; v += nw) {
      int k;
      const float* src = img0 + (size_t)wrap(rlo + v, H0, &k) * W0;
      for (int u = lane; u < nc; u += 32)
        cp_async4(region + v * nc + u, src + wrap(clo + u, W0, &k));
    }
    // meanwhile the taps' weights, as doubles
    for (int i = tid; i < PH * ra.taps; i += kThreads) {
      const int r = i / ra.taps, t = i % ra.taps;
      rw[t * PH + r] = (double)ra.weight[ry[r] * ra.taps + t];
    }
    for (int i = tid; i < PW * ca.taps; i += kThreads) {
      const int c = i / ca.taps, t = i % ca.taps;
      cw[t * PW + c] = (double)ca.weight[cx[c] * ca.taps + t];
    }
    cp_async_wait_all();
    __syncthreads();
    if (h_first) {
      // first axis: tmp[r][u] = the H taps of halo row r at column u
      for (int r = warp; r < PH; r += nw) {
        const float* src = region + (rsu[r] - rlo) * nc;
        for (int u0 = lane; u0 < nc; u0 += 32 * kIlp) {
          const float* x[kIlp];
          const double* wt[kIlp];
          int n[kIlp];
#pragma unroll
          for (int q = 0; q < kIlp; ++q) {
            const int u = u0 + 32 * q;
            x[q] = src + (u < nc ? u : 0);
            wt[q] = rw + r;
            n[q] = u < nc ? rcn[r] : 0;
          }
          double acc[kIlp];
          tap_chains(x, nc, wt, PH, n, acc);
#pragma unroll
          for (int q = 0; q < kIlp; ++q)
            if (n[q]) tmp[r * nc + u0 + 32 * q] = (float)acc[q];
        }
      }
      __syncthreads();
      // second axis: the W taps of halo column c over the intermediate
      for (int i0 = tid; i0 < PH * PW; i0 += kThreads * kIlp) {
        const float* x[kIlp];
        const double* wt[kIlp];
        int n[kIlp];
#pragma unroll
        for (int q = 0; q < kIlp; ++q) {
          const int i = i0 + kThreads * q;
          const int r = i < PH * PW ? i / PW : 0, c = i % PW;
          x[q] = tmp + r * nc + (csu[c] - clo);
          wt[q] = cw + c;
          n[q] = i < PH * PW ? ccn[c] : 0;
        }
        double acc[kIlp];
        tap_chains(x, 1, wt, PW, n, acc);
#pragma unroll
        for (int q = 0; q < kIlp; ++q)
          if (n[q]) pix[i0 + kThreads * q] = (float)acc[q];
      }
    } else {
      // first axis: tmp[v][c] = the W taps of halo column c on region row v
      for (int i0 = tid; i0 < nr * PW; i0 += kThreads * kIlp) {
        const float* x[kIlp];
        const double* wt[kIlp];
        int n[kIlp];
#pragma unroll
        for (int q = 0; q < kIlp; ++q) {
          const int i = i0 + kThreads * q;
          const int v = i < nr * PW ? i / PW : 0, c = i % PW;
          x[q] = region + v * nc + (csu[c] - clo);
          wt[q] = cw + c;
          n[q] = i < nr * PW ? ccn[c] : 0;
        }
        double acc[kIlp];
        tap_chains(x, 1, wt, PW, n, acc);
#pragma unroll
        for (int q = 0; q < kIlp; ++q)
          if (n[q]) tmp[i0 + kThreads * q] = (float)acc[q];
      }
      __syncthreads();
      // second axis: the H taps of halo row r over the intermediate
      for (int i0 = tid; i0 < PH * PW; i0 += kThreads * kIlp) {
        const float* x[kIlp];
        const double* wt[kIlp];
        int n[kIlp];
#pragma unroll
        for (int q = 0; q < kIlp; ++q) {
          const int i = i0 + kThreads * q;
          const int r = i < PH * PW ? i / PW : 0, c = i % PW;
          x[q] = tmp + (rsu[r] - rlo) * PW + c;
          wt[q] = rw + r;
          n[q] = i < PH * PW ? rcn[r] : 0;
        }
        double acc[kIlp];
        tap_chains(x, PW, wt, PH, n, acc);
#pragma unroll
        for (int q = 0; q < kIlp; ++q)
          if (n[q]) pix[i0 + kThreads * q] = (float)acc[q];
      }
    }
  }
  __syncthreads();

  // FAST at both thresholds on the tile and its 1-pixel ring, walked in
  // the halo tile's row stride so that a warp reads consecutive words
  float* sc = work;  // [2][SH][SW]
  const float tm = fminf(t0, t1);
  for (int i = tid; i < SH * PW; i += kThreads) {
    const int sy = i / PW, sx = i % PW;
    if (sx >= SW) continue;
    const float* c = pix + (sy + 3) * PW + (sx + 3);
    const float p = c[0];
    float* out = sc + sy * SW + sx;
    // a run of nine contains two neighbouring compass pixels (0 and 4, 4
    // and 8, ...), brighter or darker at the lower threshold if at either
    const float hi_m = p + tm, lo_m = p - tm;
    const float n = c[-3 * PW], e = c[3], s_ = c[3 * PW], w_ = c[-3];
    const bool nb = n > hi_m, eb = e > hi_m, sb = s_ > hi_m, wb = w_ > hi_m;
    const bool nd = n < lo_m, ed = e < lo_m, sd = s_ < lo_m, wd = w_ < lo_m;
    if (!((nb && eb) || (eb && sb) || (sb && wb) || (wb && nb) ||
          (nd && ed) || (ed && sd) || (sd && wd) || (wd && nd))) {
      out[0] = out[SH * SW] = 0.f;
      continue;
    }
    float q[16], dq[16];
#pragma unroll
    for (int k = 0; k < 16; ++k) {
      q[k] = c[kCircleY[k] * PW + kCircleX[k]];
      dq[k] = fabsf(q[k] - p);
    }
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
        const float term = (b || d) ? dq[k] : 0.f;
        s = k == 0 ? term : s + term;
      }
      out[t * SH * SW] = (has_run9(bright) || has_run9(dark)) ? s : 0.f;
    }
  }
  __syncthreads();

  // suppression and the border; the tile's level pixels, scores and masked
  // values written once
  const size_t plane = (size_t)h * w;
  float* __restrict__ lev = L.level[lvl];
  float* __restrict__ score = L.score[lvl];
  float* __restrict__ masked = L.masked[lvl];
  int kept = 0;
  for (int i = tid; i < TH * TW; i += kThreads) {
    const int oy = i / TW, ox = i % TW;
    const int gy = y0 + oy, gx = x0 + ox;
    if (gy >= h || gx >= w) continue;
    const size_t at = (size_t)gy * w + gx;
    lev[at] = pix[(oy + kHalo) * PW + ox + kHalo];
    const bool inb = gy >= edge && gy < h - edge && gx >= edge &&
                     gx < w - edge;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const float* s0 = sc + t * SH * SW + (oy + 1) * SW + ox + 1;
      const float s = s0[0];
      bool m = inb && s > 0.f;
#pragma unroll
      for (int dy = -1; dy <= 1; ++dy) {
#pragma unroll
        for (int dx = -1; dx <= 1; ++dx) {
          const int ny = gy + dy, nx = gx + dx;
          if ((dy == 0 && dx == 0) || ny < 0 || ny >= h || nx < 0 || nx >= w)
            continue;
          m = m && s >= s0[dy * SW + dx];
        }
      }
      score[t * plane + at] = s;
      masked[t * plane + at] = m ? s : -1.f;
      if (t == 0 && m) ++kept;
    }
  }
  kept = __reduce_add_sync(0xffffffffu, kept);
  if (lane == 0 && kept) atomicAdd(&misc[4], kept);
  __syncthreads();
  if (tid == 0 && misc[4]) atomicAdd(counts + lvl, misc[4]);
}

int launch(const FastLevels& L, int tiles, const float* img0, int H0, int W0,
           int* counts, float t0, float t1, int edge, int taps_max,
           int work_floats, cudaStream_t stream) {
  // the halo tile and the work area take dynamic shared memory beyond the
  // default 48 KB: allowed once per device for the most this launch can
  // ask (the host sizes the work area)
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  const size_t smem = smem_bytes(taps_max, work_floats);
  constexpr int kSmemMax = 227 * 1024;
  if (smem > (size_t)kSmemMax) return (int)cudaErrorInvalidValue;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(orb_fast_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               kSmemMax);
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  orb_fast_kernel<<<tiles, kThreads, smem, stream>>>(
      L, img0, H0, W0, counts, t0, t1, edge, taps_max, work_floats);
  return (int)cudaGetLastError();
}

}  // namespace

// img0: (H0, W0) float32 on the device. n levels; per level l: hw[2l],
// hw[2l + 1] its size, h_first[l] its axis order, ptrs[9l .. 9l + 8] the
// device pointers of its level image (h, w), score and masked maps (2, h,
// w), its row taps (start, count, weights) and its column taps; taps[2l],
// taps[2l + 1] the rows' and columns' tap widths (level 0 takes none).
// counts: (n,) int32 on the device, zeroed by the caller. work_floats: the
// work area the host sized (at least the score ring).
extern "C" int orb_fast(const float* img0, int H0, int W0, int n,
                        const int* hw, const int* h_first,
                        void* const* ptrs, const int* taps, int* counts,
                        float t0, float t1, int edge, int work_floats,
                        void* stream) {
  if (n < 1 || n > kMaxLevels || H0 < 1 || W0 < 1)
    return (int)cudaErrorInvalidValue;
  if (work_floats < 2 * SH * SW) return (int)cudaErrorInvalidValue;
  FastLevels L{};
  L.n = n;
  int tiles = 0, taps_max = 1;
  for (int l = 0; l < n; ++l) {
    const int h = hw[2 * l], w = hw[2 * l + 1];
    if (h < 1 || w < 1 || (l == 0 && (h != H0 || w != W0)))
      return (int)cudaErrorInvalidValue;
    void* const* p = ptrs + 9 * l;
    L.level[l] = static_cast<float*>(p[0]);
    L.score[l] = static_cast<float*>(p[1]);
    L.masked[l] = static_cast<float*>(p[2]);
    if (l > 0) {
      L.rows[l] = Axis{static_cast<const int*>(p[3]),
                       static_cast<const int*>(p[4]),
                       static_cast<const float*>(p[5]), taps[2 * l]};
      L.cols[l] = Axis{static_cast<const int*>(p[6]),
                       static_cast<const int*>(p[7]),
                       static_cast<const float*>(p[8]), taps[2 * l + 1]};
      if (taps[2 * l] < 1 || taps[2 * l] > kMaxTaps || taps[2 * l + 1] < 1 ||
          taps[2 * l + 1] > kMaxTaps)
        return (int)cudaErrorInvalidValue;
      taps_max = taps[2 * l] > taps_max ? taps[2 * l] : taps_max;
      taps_max = taps[2 * l + 1] > taps_max ? taps[2 * l + 1] : taps_max;
    }
    L.h[l] = h;
    L.w[l] = w;
    L.h_first[l] = h_first[l];
    L.tiles_x[l] = (w + TW - 1) / TW;
    L.tile_start[l] = tiles;
    tiles += L.tiles_x[l] * ((h + TH - 1) / TH);
  }
  for (int l = n; l <= kMaxLevels; ++l) L.tile_start[l] = tiles;
  return launch(L, tiles, img0, H0, W0, counts, t0, t1, edge, taps_max,
                work_floats, static_cast<cudaStream_t>(stream));
}
