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
// What bounds it on an H100: bytes. The input is 66 floats per cell (264 B)
// and the output 2*nc floats; at batch 32 that is 51.6 MB, 15 us at
// 3.35 TB/s. The work is some 70 float ops per pixel (65 exp per cell).
//
// Design: one CTA per (image, tile of S cell rows x CW cell columns); the
// wrapper picks the tile (ops/cuda_kernels.detect_grid) so that a batch of
// one still gives a CTA per SM and large batches recompute little halo.
// Two CTAs of 512 threads fit on an SM (<= 64 registers, 47 KB of shared
// memory each at 8 x 16 cells), so one CTA's loads overlap another's sweep.
//  - Phase 1: the softmax of every cell of the tile and of a one-cell halo
//    around it, one warp per cell (the loads of kInFlight cells in flight
//    per warp), staged in shared memory at pixel addresses: (S*8+4) rows x
//    (CW*8+4) columns, the two halo pixels each side that the 5x5 window
//    needs. The row stride is padded to 8 mod 32 floats, so a warp's 4
//    rows x 8 columns of a cell fall on 32 distinct banks. The tile's heat
//    is staged too. (Copying the tile's logits to shared memory first, with
//    all threads, was 20% slower at batch 32.)
//  - Phase 2: a column sweep. Each thread owns one pixel column of one cell
//    row and walks its 8 rows plus 2 halo rows each side, reading 5
//    neighbours per row (60 conflict-free loads for 8 pixels); the
//    horizontal 5-max and the 3 columns of the soft-argmax stay in
//    registers, and the reliability's x pass is taken once per heat row. Coordinates are clamped to the image: for the soft-
//    argmax that is its border rule, and for the NMS max a clamped
//    neighbour repeats a pixel inside the window, so the max equals the
//    image-bounded one.
//  - Extraction: the 8 threads of a cell (lanes 8j..8j+7) count the cell's
//    scores above -1 and run warp arg-max rounds only for those (typically
//    0-2, at most nc). The remaining slots hold the v == -1 pixels in
//    ascending channel order (which is ascending aux), each placed by a
//    popc rank over the cell's 64-bit mask. A cell with a score below -1
//    (a negative reliability) or a NaN runs nc full rounds. The soft-argmax
//    aux is computed only for the pixels the slots can hold. The slots are
//    staged in shared memory and written as whole rows.
//
// Exactness: phase 1 is the previous kernel's softmax (same fmaxf and
// shuffle trees, expf, e/s); the reliability positions are computed as the
// JAX cell path does (pos = float(x) * s - 0.5 with s rounded to float once
// on the host, x pass before y pass) and the soft-argmax sums are grouped
// as in the TPU kernel (ty = up+mid+dn, s = ty0+ty1+ty2, sx = ty2-ty0,
// sy = uy0+uy1+uy2). This file is compiled with --fmad=false so nvcc
// contracts none of these products and sums into FMAs, which would move
// floor() decisions, weights and quantization steps; expf is the accurate
// one (no fast math). So vals and aux equal the previous kernel's bit for
// bit, every slot included.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kMaxThreads = 512;
// two CTAs of 512 threads per SM (<= 64 registers): 1.3x faster at batch
// 32 than one CTA per SM with no register cap (PERF.md)
constexpr int kMinBlocks = 2;
// phase 1: the cells whose loads a warp has in flight together (4 was 1-5%
// faster than 2 at batch 32)
constexpr int kInFlight = 4;
constexpr unsigned kFull = 0xffffffffu;

// (v, a) <- the better of (v, a) and (v2, a2): larger score, then smaller aux.
__device__ __forceinline__ void keep_better(float& v, float& a, float v2,
                                            float a2) {
  if (v2 > v || (v2 == v && a2 < a)) {
    v = v2;
    a = a2;
  }
}

// sum over the 8 lanes of this lane's cell (lanes 8j..8j+7)
__device__ __forceinline__ int cell_sum(int x) {
  x += __shfl_xor_sync(kFull, x, 4);
  x += __shfl_xor_sync(kFull, x, 2);
  return x + __shfl_xor_sync(kFull, x, 1);
}

__host__ __device__ __forceinline__ int prob_stride(int CW) {
  const int w = CW * 8 + 4;
  return w + (40 - w % 32) % 32;  // == 8 (mod 32)
}

__global__ void __launch_bounds__(kMaxThreads, kMinBlocks)
detect_candidates_kernel(const float* __restrict__ logits,  // (B,H8,W8,65)
                         const float* __restrict__ heat,    // (B,H8,W8)
                         float* __restrict__ vals,          // (B,H8,nc,W8)
                         float* __restrict__ aux,           // (B,H8,nc,W8)
                         int H8, int W8, int nc, int S, int CW, int parts,
                         float threshold, float temp, float scale_x,
                         float scale_y) {
  extern __shared__ __align__(16) float smem[];
  const int nthreads = blockDim.x, nwarps = nthreads >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int c0 = (blockIdx.x / parts) * S, c1 = min(c0 + S, H8);  // cell rows
  const int q0 = (blockIdx.x % parts) * CW, q1 = min(q0 + CW, W8);  // cols
  const int W = W8 * 8, H = H8 * 8;
  const int sw = prob_stride(CW), hsw = CW + 2;
  const int y_base = c0 * 8 - 2, x_base = q0 * 8 - 2;
  const int nrows = (c1 - c0) * 8 + 4, ncols = (q1 - q0) * 8 + 4;
  // per pixel row of the tile: the reliability's y weights wy0, wy1 and
  // whether its upper heat row is cy-1 (1) or cy (0)
  float4* rowt = reinterpret_cast<float4*>(smem);  // S*8
  float* prob = smem + S * 8 * 4;          // nrows x sw
  float* hs = prob + (S * 8 + 4) * sw;     // heat, cells [c0-1,c1] x [q0-1,q1]
  float* outv = hs + (S + 2) * hsw;        // (S, nc, CW)
  float* outa = outv + S * nc * CW;

  // ---- phase 0: the tile's heat (zero outside the image) and row table ----
  for (int r = threadIdx.x; r < S * 8; r += nthreads) {
    const int y = c0 * 8 + r;
    const float posy = __fsub_rn(__fmul_rn((float)y, scale_y), 0.5f);
    const float fy0 = floorf(posy);
    const float wyf = __fsub_rn(posy, fy0);
    const int y0 = (int)fy0;  // cy - 1 or cy
    rowt[r] = make_float4((y0 >= 0 && y0 < H8) ? __fsub_rn(1.f, wyf) : 0.f,
                          (y0 + 1 < H8) ? wyf : 0.f, y0 < (y >> 3) ? 1.f : 0.f,
                          0.f);
  }
  const float* hb = heat + (size_t)b * H8 * W8;
  for (int i = threadIdx.x; i < (S + 2) * hsw; i += nthreads) {
    const int gy = c0 - 1 + i / hsw, gx = q0 - 1 + i % hsw;
    hs[i] = (gy >= 0 && gy < H8 && gx >= 0 && gx < W8) ? hb[gy * W8 + gx]
                                                       : 0.f;
  }

  // ---- phase 1: softmax per cell of the tile and its halo ----
  const int h0 = max(c0 - 1, 0), h1 = min(c1 + 1, H8);
  const int g0 = max(q0 - 1, 0), g1 = min(q1 + 1, W8);
  const int gw = g1 - g0, ncell = (h1 - h0) * gw;
  int ry = warp / gw, rx = warp % gw;  // cell `cell` in the halo'd tile
  for (int cell = warp; cell < ncell; cell += kInFlight * nwarps) {
    float x[kInFlight][3];
    int cyv[kInFlight], cxv[kInFlight];
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {  // every cell's loads first
      const bool in = cell + u * nwarps < ncell;  // else loaded, unused
      cyv[u] = h0 + (in ? ry : 0);
      cxv[u] = g0 + (in ? rx : 0);
      for (rx += nwarps; rx >= gw; rx -= gw) ++ry;  // the next nwarps-th cell
      const float* l = logits + ((size_t)(b * H8 + cyv[u]) * W8 + cxv[u]) * 65;
      x[u][0] = l[lane] * temp;
      x[u][1] = l[lane + 32] * temp;
      x[u][2] = lane == 0 ? l[64] * temp : -INFINITY;
    }
#pragma unroll
    for (int u = 0; u < kInFlight; ++u) {
      if (cell + u * nwarps >= ncell) break;  // uniform across the warp
      float m = fmaxf(fmaxf(x[u][0], x[u][1]), x[u][2]);
      for (int o = 16; o > 0; o >>= 1)
        m = fmaxf(m, __shfl_xor_sync(kFull, m, o));
      const float e0 = expf(x[u][0] - m), e1 = expf(x[u][1] - m);
      float s = e0 + e1 + (lane == 0 ? expf(x[u][2] - m) : 0.f);
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      // channel c = py*8+px: lane holds rows lane/8 and lane/8+4, column lane%8
      const int r0 = cyv[u] * 8 + (lane >> 3) - y_base;
      const int col = cxv[u] * 8 + (lane & 7) - x_base;
      if (col >= 0 && col < ncols) {
        if (r0 >= 0 && r0 < nrows) prob[r0 * sw + col] = e0 / s;
        if (r0 + 4 >= 0 && r0 + 4 < nrows) prob[(r0 + 4) * sw + col] = e1 / s;
      }
    }
  }
  __syncthreads();

  // ---- phase 2: column sweep, one thread per (cell row, pixel column) ----
  const int tw = CW * 8, ntask = S * tw;
  const int px = lane & 7;  // == the pixel column within the cell
  for (int t0 = 0; t0 < ntask; t0 += nthreads) {  // uniform across the CTA
    const int t = t0 + threadIdx.x;
    const int cr = t / tw, xl = t % tw;
    const int cy = c0 + cr, cxl = xl >> 3;
    const bool active = t < ntask && cy < c1 && q0 + cxl < q1;
    // rows y0r-2 .. y0r+9 of the 5-wide horizontal max and of the
    // soft-argmax's 3 columns, clamped to the image
    float v[8], a[8], hm[12], u0[12], u1[12], u2[12];
    if (active) {
      const int x = q0 * 8 + xl, y0r = cy * 8;
      int xc[5];
#pragma unroll
      for (int k = 0; k < 5; ++k) xc[k] = min(max(x + k - 2, 0), W - 1) - x_base;
#pragma unroll
      for (int i = 0; i < 12; ++i) {
        const float* row = prob + (min(max(y0r - 2 + i, 0), H - 1) - y_base) * sw;
        const float n0 = row[xc[0]], n1 = row[xc[1]], n2 = row[xc[2]];
        const float n3 = row[xc[3]], n4 = row[xc[4]];
        hm[i] = fmaxf(fmaxf(fmaxf(n0, n1), fmaxf(n2, n3)), n4);
        u0[i] = n1;
        u1[i] = n2;
        u2[i] = n3;
      }
      // reliability: the x pass over the three heat rows a pixel of cell
      // row cy can reach (cy-1..cy+1), then the y pass per pixel
      const float posx = __fsub_rn(__fmul_rn((float)x, scale_x), 0.5f);
      const float fx0 = floorf(posx);
      const float wxf = __fsub_rn(posx, fx0);
      const int x0 = (int)fx0;
      const float wx0 = (x0 >= 0 && x0 < W8) ? __fsub_rn(1.f, wxf) : 0.f;
      const float wx1 = (x0 + 1 < W8) ? wxf : 0.f;
      float gx[3];  // staged zeros outside the image
#pragma unroll
      for (int k = 0; k < 3; ++k) {
        const float* hr = hs + (cr + k) * hsw + (x0 - (q0 - 1));
        gx[k] = __fadd_rn(__fmul_rn(hr[0], wx0), __fmul_rn(hr[1], wx1));
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const int y = y0r + i;
        const float p = u1[i + 2];
        const float mx = fmaxf(fmaxf(fmaxf(hm[i], hm[i + 1]),
                                     fmaxf(hm[i + 2], hm[i + 3])), hm[i + 4]);
        const bool survivor = (p == mx) && (p > threshold);
        const float4 rt = rowt[cr * 8 + i];
        const bool up = rt.z != 0.f;
        const float rel = __fadd_rn(__fmul_rn(up ? gx[0] : gx[1], rt.x),
                                    __fmul_rn(up ? gx[1] : gx[2], rt.y));
        const bool last = (y == H - 1) || (x == W - 1);
        v[i] = survivor ? __fmul_rn(last ? 0.f : p, rel) : -1.f;
      }
    } else {
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = -1.f;
    }

    // ---- extraction: the 8 lanes of a cell hold its 64 pixels ----
    int hi = 0, fill = 0;  // bit i: pixel row i scores above -1 / exactly -1
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      hi |= (v[i] > -1.f) << i;
      fill |= (v[i] == -1.f) << i;
    }
    const int n_hi = cell_sum(__popc(hi));
    const bool odd = cell_sum((hi | fill) != 0xff) > 0;  // below -1, or NaN

    // The aux of the pixels the extraction can read: in an odd cell every
    // pixel's; else those scoring above -1 and channels below nc (a v == -1
    // pixel lands in slot n_hi + its rank among them, which is at least its
    // channel; every pixel's aux costs 7% more at batch 32).
    // The others keep -1, which no aux equals.
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      a[i] = -1.f;
      if (active && (odd || ((hi >> i) & 1) || i * 8 + px < nc)) {
        // 3x3 soft-argmax: columns x-1, x, x+1 and rows y-1, y, y+1, clamped
        const float ty0 = __fadd_rn(__fadd_rn(u0[i + 1], u0[i + 2]), u0[i + 3]);
        const float ty1 = __fadd_rn(__fadd_rn(u1[i + 1], u1[i + 2]), u1[i + 3]);
        const float ty2 = __fadd_rn(__fadd_rn(u2[i + 1], u2[i + 2]), u2[i + 3]);
        const float uy0 = __fsub_rn(u0[i + 3], u0[i + 1]);
        const float uy1 = __fsub_rn(u1[i + 3], u1[i + 1]);
        const float uy2 = __fsub_rn(u2[i + 3], u2[i + 1]);
        const float ssum = __fadd_rn(__fadd_rn(ty0, ty1), ty2);
        const float sx = __fsub_rn(ty2, ty0);
        const float sy = __fadd_rn(__fadd_rn(uy0, uy1), uy2);
        const float inv = __fdiv_rn(1.f, fmaxf(ssum, 1e-9f));
        const float offx = fminf(fmaxf(__fmul_rn(sx, inv), -1.f), 1.f);
        const float offy = fminf(fmaxf(__fmul_rn(sy, inv), -1.f), 1.f);
        const float qx = rintf(__fmul_rn(__fadd_rn(offx, 1.f), 255.f));
        const float qy = rintf(__fmul_rn(__fadd_rn(offy, 1.f), 255.f));
        a[i] = (float)(i * 8 + px) * 262144.f + qx * 512.f + qy;  // < 2^24
      }
    }
    const int rounds = odd ? nc : min(n_hi, nc);
    const int warp_rounds = __reduce_max_sync(kFull, rounds);
    float* ov = outv + (cr * nc) * CW + cxl;
    float* oa = outa + (cr * nc) * CW + cxl;
    for (int r = 0; r < warp_rounds; ++r) {
      float bv = v[0], ba = a[0];
#pragma unroll
      for (int i = 1; i < 8; ++i) keep_better(bv, ba, v[i], a[i]);
      for (int o = 4; o > 0; o >>= 1) {
        const float ov2 = __shfl_xor_sync(kFull, bv, o);
        const float oa2 = __shfl_xor_sync(kFull, ba, o);
        keep_better(bv, ba, ov2, oa2);
      }
      if (active && px == 0 && r < rounds) {
        ov[r * CW] = bv;
        oa[r * CW] = ba;
      }
      // aux is unique within a cell (the channel sits in its high bits)
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (a[i] == ba) v[i] = -INFINITY;
    }
    // the v == -1 pixels fill the slots after the rounds, by channel; a
    // pixel's slot is at least its channel, so only channels below nc count
    unsigned long long m = 0;
#pragma unroll
    for (int i = 0; i < 8; ++i)
      if (i * 8 < nc && ((fill >> i) & 1)) m |= 1ull << (i * 8 + px);
    m |= __shfl_xor_sync(kFull, m, 4);
    m |= __shfl_xor_sync(kFull, m, 2);
    m |= __shfl_xor_sync(kFull, m, 1);
    if (active && !odd) {
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        if (i * 8 >= nc) break;  // uniform
        const int ch = i * 8 + px;
        const int slot = n_hi + __popcll(m & ((1ull << ch) - 1));
        if (((fill >> i) & 1) && slot < nc) {
          ov[slot * CW] = -1.f;
          oa[slot * CW] = a[i];
        }
      }
    }
  }
  __syncthreads();

  // ---- the tile's slots, as whole rows of (q1 - q0) cells ----
  const int nq = q1 - q0;
  for (int i = threadIdx.x; i < (c1 - c0) * nc * nq; i += nthreads) {
    const int row = i / nq, j = i % nq;  // row = cell row * nc + slot
    const size_t off = ((size_t)b * H8 * nc + (size_t)c0 * nc + row) * W8 + q0 + j;
    vals[off] = outv[row * CW + j];
    aux[off] = outa[row * CW + j];
  }
}

constexpr int kSmemMax = 227 * 1024;

// Allow the kernel all the shared memory a CTA may have, once per device.
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(detect_candidates_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemMax);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace

// Shared memory of one CTA, in bytes: staged probabilities, heat and slots.
extern "C" int detect_smem_bytes(int S, int CW, int nc) {
  return (S * 8 * 4 + (S * 8 + 4) * prob_stride(CW) + (S + 2) * (CW + 2) +
          2 * S * nc * CW) * (int)sizeof(float);
}

extern "C" int detect_candidates(const float* logits, const float* heat,
                                 float* vals, float* aux, int B, int H8,
                                 int W8, int nc, int S, int parts, int threads,
                                 float threshold, float temp, float scale_x,
                                 float scale_y, void* stream) {
  const int CW = (W8 + parts - 1) / parts;
  const int smem = detect_smem_bytes(S, CW, nc);
  const cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  if (smem > kSmemMax) return (int)cudaErrorInvalidValue;
  dim3 grid(((H8 + S - 1) / S) * parts, B);
  detect_candidates_kernel<<<grid, threads, smem, (cudaStream_t)stream>>>(
      logits, heat, vals, aux, H8, W8, nc, S, CW, parts, threshold, temp,
      scale_x, scale_y);
  return (int)cudaGetLastError();
}
