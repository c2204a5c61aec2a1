// Fused keypoint-detection post-processing: per-cell NMS survivors with
// their ranking scores and packed sub-pixel offsets.
//
// Replaces: xfeatslam_tpu/ops/pallas_kernels.py detect_candidates
// (:373-428; body _detect_kernel :344-370 -> _strip_candidates :164-341).
//
// For each 8x8 cell of each image: 65-way softmax (dustbin dropped) ->
// 5x5 NMS at full resolution (p == local max && p > threshold) -> bilinear
// reliability at the pixel -> ranked score p*rel (last pixel row/column
// zeroed; -1 for non-survivors) -> 3x3 soft-argmax offsets quantized and
// packed as ch<<18 | qx<<9 | qy -> the cell's top-nc (score, aux), ties to
// the smaller aux. Output layout (B,H8,nc,W8), as the TPU kernel's.
//
// What bounds it on an H100: the input is 66 floats per cell (264 B) and
// the output 2*nc floats, so per image the traffic is ~1.4 MB; the work is
// some 70 float ops per pixel (65 exp per cell). Both bounds are microsecond
// scale at batch 32, so the kernel is bound by latency and by the shared-
// memory reads of the neighbour ops, not by HBM.
//
// Design: one CTA per (image, strip of S cell rows). Phase 1 computes the
// softmax once per cell (one warp per cell, for the strip and a one-cell-
// row halo above and below) and stages the probabilities in shared memory
// at full-resolution pixel addresses, keeping only the two halo pixel rows
// each neighbour op needs: (S*8+4) rows x W floats. Phase 2 gives each
// interior cell one warp, two channels per lane: NMS is a direct 5x5 max
// over shared memory (max is exact, so this equals the separable form),
// the reliability and the soft-argmax are evaluated per pixel, and the
// top-nc extraction is nc rounds of a warp arg-max on (score, aux). Nothing
// but the candidates reaches HBM. The TPU kernel's transposed channel
// layout, channel rolls and fori_loop strips are Mosaic workarounds and are
// not carried over.
//
// Exactness: the reliability positions are computed as the JAX cell path
// does (pos = float(x) * s - 0.5 with s rounded to float once on the host,
// x pass before y pass) and the soft-argmax sums are grouped as in the TPU
// kernel. This file is compiled with --fmad=false so nvcc contracts none of
// these products and sums into FMAs, which would move floor() decisions,
// weights and quantization steps; expf is the accurate one (no fast math).

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// (v, a) <- the better of (v, a) and (v2, a2): larger score, then smaller aux.
__device__ __forceinline__ void keep_better(float& v, float& a, float v2,
                                            float a2) {
  if (v2 > v || (v2 == v && a2 < a)) {
    v = v2;
    a = a2;
  }
}

__global__ void __launch_bounds__(kThreads)
detect_candidates_kernel(const float* __restrict__ logits,  // (B,H8,W8,65)
                         const float* __restrict__ heat,    // (B,H8,W8)
                         float* __restrict__ vals,          // (B,H8,nc,W8)
                         float* __restrict__ aux,           // (B,H8,nc,W8)
                         int H8, int W8, int nc, int S, float threshold,
                         float temp, float scale_x, float scale_y) {
  extern __shared__ float prob[];  // rows [y_base, y_base + nrows) x W
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * S;
  const int c1 = min(c0 + S, H8);
  const int W = W8 * 8, H = H8 * 8;
  const int y_base = c0 * 8 - 2;
  const int nrows = (c1 - c0) * 8 + 4;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;

  // ---- phase 1: softmax per cell of the strip and its halo rows ----
  const int h0 = max(c0 - 1, 0), h1 = min(c1 + 1, H8);
  for (int cell = warp; cell < (h1 - h0) * W8; cell += kWarps) {
    const int cy = h0 + cell / W8, cx = cell % W8;
    const float* l = logits + ((size_t)(b * H8 + cy) * W8 + cx) * 65;
    const float x0 = l[lane] * temp;
    const float x1 = l[lane + 32] * temp;
    const float x2 = lane == 0 ? l[64] * temp : -INFINITY;
    float m = fmaxf(fmaxf(x0, x1), x2);
    for (int o = 16; o > 0; o >>= 1) m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
    const float e0 = expf(x0 - m), e1 = expf(x1 - m);
    float s = e0 + e1 + (lane == 0 ? expf(x2 - m) : 0.f);
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
    // channel c = py*8+px: lane holds rows lane/8 and lane/8+4, column lane%8
    const int r0 = cy * 8 + (lane >> 3) - y_base;
    const int col = cx * 8 + (lane & 7);
    if (r0 >= 0 && r0 < nrows) prob[r0 * W + col] = e0 / s;
    if (r0 + 4 >= 0 && r0 + 4 < nrows) prob[(r0 + 4) * W + col] = e1 / s;
  }
  __syncthreads();

  const float* hb = heat + (size_t)b * H8 * W8;
  // x-pass of the reliability bilinear on heat row ry (zero outside)
  auto gx_row = [&](int ry, int x0, float wx0, float wx1) -> float {
    if (ry < 0 || ry >= H8) return 0.f;
    const float* hr = hb + ry * W8;
    const float t0 = (x0 >= 0 && x0 < W8) ? hr[x0] : 0.f;
    const float t1 = (x0 + 1 < W8) ? hr[x0 + 1] : 0.f;
    return __fadd_rn(__fmul_rn(t0, wx0), __fmul_rn(t1, wx1));
  };
  auto P = [&](int y, int x) -> float { return prob[(y - y_base) * W + x]; };

  // ---- phase 2: one warp per interior cell, channels lane and lane+32 ----
  for (int cell = warp; cell < (c1 - c0) * W8; cell += kWarps) {
    const int cy = c0 + cell / W8, cx = cell % W8;
    float v[2], a[2];
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int ch = lane + 32 * h;
      const int y = cy * 8 + (ch >> 3), x = cx * 8 + (ch & 7);
      const float p = P(y, x);

      // 5x5 NMS, image-bounded
      float mx = -INFINITY;
      for (int yy = max(y - 2, 0); yy <= min(y + 2, H - 1); ++yy)
        for (int xx = max(x - 2, 0); xx <= min(x + 2, W - 1); ++xx)
          mx = fmaxf(mx, P(yy, xx));
      const bool survivor = (p == mx) && (p > threshold);

      // bilinear reliability, x pass then y pass
      const float posx = __fsub_rn(__fmul_rn((float)x, scale_x), 0.5f);
      const float fx0 = floorf(posx);
      const float wxf = __fsub_rn(posx, fx0);
      const int x0 = (int)fx0;
      const float wx0 = (x0 >= 0 && x0 < W8) ? __fsub_rn(1.f, wxf) : 0.f;
      const float wx1 = (x0 + 1 < W8) ? wxf : 0.f;
      const float posy = __fsub_rn(__fmul_rn((float)y, scale_y), 0.5f);
      const float fy0 = floorf(posy);
      const float wyf = __fsub_rn(posy, fy0);
      const int y0 = (int)fy0;
      const float wy0 = (y0 >= 0 && y0 < H8) ? __fsub_rn(1.f, wyf) : 0.f;
      const float wy1 = (y0 + 1 < H8) ? wyf : 0.f;
      const float rel =
          __fadd_rn(__fmul_rn(gx_row(y0, x0, wx0, wx1), wy0),
                    __fmul_rn(gx_row(y0 + 1, x0, wx0, wx1), wy1));
      const bool last = (y == H - 1) || (x == W - 1);
      v[h] = survivor ? __fmul_rn(last ? 0.f : p, rel) : -1.f;

      // 3x3 soft-argmax, coordinates clamped to the image
      const int ym = max(y - 1, 0), yp = min(y + 1, H - 1);
      const int xs[3] = {max(x - 1, 0), x, min(x + 1, W - 1)};
      float ty[3], uy[3];
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float up = P(ym, xs[k]), mid = P(y, xs[k]), dn = P(yp, xs[k]);
        ty[k] = __fadd_rn(__fadd_rn(up, mid), dn);
        uy[k] = __fsub_rn(dn, up);
      }
      const float ssum = __fadd_rn(__fadd_rn(ty[0], ty[1]), ty[2]);
      const float sx = __fsub_rn(ty[2], ty[0]);
      const float sy = __fadd_rn(__fadd_rn(uy[0], uy[1]), uy[2]);
      const float inv = __fdiv_rn(1.f, fmaxf(ssum, 1e-9f));
      const float offx = fminf(fmaxf(__fmul_rn(sx, inv), -1.f), 1.f);
      const float offy = fminf(fmaxf(__fmul_rn(sy, inv), -1.f), 1.f);
      const float qx = rintf(__fmul_rn(__fadd_rn(offx, 1.f), 255.f));
      const float qy = rintf(__fmul_rn(__fadd_rn(offy, 1.f), 255.f));
      a[h] = (float)ch * 262144.f + qx * 512.f + qy;  // exact: < 2^24
    }

    // per-cell top-nc: nc rounds of a warp arg-max on (score, aux)
    for (int r = 0; r < nc; ++r) {
      float bv = v[0], ba = a[0];
      keep_better(bv, ba, v[1], a[1]);
      for (int o = 16; o > 0; o >>= 1) {
        const float ov = __shfl_xor_sync(kFull, bv, o);
        const float oa = __shfl_xor_sync(kFull, ba, o);
        keep_better(bv, ba, ov, oa);
      }
      if (lane == 0) {
        const size_t off = ((size_t)(b * H8 + cy) * nc + r) * W8 + cx;
        vals[off] = bv;
        aux[off] = ba;
      }
      // aux is unique within a cell (the channel sits in its high bits)
      if (a[0] == ba) v[0] = -INFINITY;
      if (a[1] == ba) v[1] = -INFINITY;
    }
  }
}

}  // namespace

extern "C" int detect_candidates(const float* logits, const float* heat,
                                 float* vals, float* aux, int B, int H8,
                                 int W8, int nc, int S, float threshold,
                                 float temp, float scale_x, float scale_y,
                                 void* stream) {
  const size_t smem = (size_t)(S * 8 + 4) * W8 * 8 * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      detect_candidates_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((H8 + S - 1) / S, B);
  detect_candidates_kernel<<<grid, kThreads, smem, (cudaStream_t)stream>>>(
      logits, heat, vals, aux, H8, W8, nc, S, threshold, temp, scale_x,
      scale_y);
  return (int)cudaGetLastError();
}
