// The XFeat network's full-resolution stem in two launches: the instance
// norm's statistics, then the norm, block1's four conv + bias + ReLU, the
// skip branch (4x4 average pool, 1x1 conv 1->24, bias) and its sum, and the
// space-to-depth of the normalized frame that feeds the keypoint head.
//
// Replaces no Pallas kernel: the JAX package leaves these convolutions to
// XLA (xfeatslam_tpu/models/xfeat.py). The port's plain route
// (ops/cuda_kernels.xfeat_stem_plain) runs them as cuDNN convs with a
// separate pass for every norm, bias, ReLU, pool, unshuffle and sum, and
// writes every intermediate map to device memory: 3.4 M values a 640x480
// frame, 38% of the whole network's.
//
// What bounds it on an H100: operations. block1 and the skip take 111 M
// multiply-adds a 640x480 frame (222 MFLOP), 0.85 ms for a batch of 256 at
// 67 TFLOP/s; the bytes (the frame read twice, both outputs written once,
// 5.5 MB a frame) take 0.42 ms at 3.35 TB/s.
//
// Design:
//  - Launch 1 (stem_stats_kernel): each CTA sums one chunk of one frame
//    (sum and sum of squares in float64, a fixed tree over its threads) and
//    writes the pair to a (B, S, 2) scratch. Frames split into S chunks so
//    that a small batch still fills the card.
//  - Launch 2 (stem_kernel): one CTA per 8 x 16 output tile at H/4 holds
//    the whole chain in shared memory: the normalized frame's 41 x 73
//    region, conv1's 39 x 71 x 4, conv2's 19 x 35 x 8, conv3's 17 x 33 x 8,
//    in two regions used in turn (conv1 and conv3 in one, the frame and
//    conv2 in the other), 76.6 KB with the weights, so two CTAs of 256
//    threads share an SM and one CTA's loads and barriers overlap the
//    other's arithmetic. Halo recompute is 1.35x on conv1, 1.30x on conv2
//    and 1.10x on conv3, 1.14x of the work in all. A thread's work in
//    each layer is a strip of output rows in one column, all channels: the
//    weights of a tap are read once (float4 broadcasts from shared memory)
//    for 3 or 4 positions and each input float4 is read once for 8 or 4
//    channels, so a shared-memory load feeds about 8 FMAs; conv1's 40
//    weights stay in registers. Shared memory's wavefronts, ~0.8 a cycle
//    of FMA issue, hold it near a quarter of the FLOP bound. The stride-2 convs read their input at
//    every second column, so conv1's and conv3's maps are stored with even
//    and odd columns apart: a warp's lanes read consecutive float4s.
//  - Padding: every map is zero outside its own level's extent, as
//    F.conv2d(padding=1) pads each layer's input; tile positions outside
//    the frame are written as 0, not computed. Output columns beyond W/4
//    (a ragged last tile) are not stored.
//  - Numerics: float32 throughout, FMA allowed; only the statistics
//    accumulate in float64. The mean and 1 / sqrt(var + 1e-5) (population
//    variance) are rounded to float32 and applied as the plain route does.
//
// Launches go on the caller's stream, allocate nothing and do not
// synchronize, so a CUDA graph captures them.

#include <cuda_runtime.h>
#include <math.h>

#include <atomic>

namespace {

constexpr int kThreads = 256;
// two CTAs an SM at up to 128 registers a thread: 11-13% faster than three
// at 80, which spilled 432 bytes a thread (PERF.md)
constexpr int kMinBlocks = 2;
constexpr int kStatsThreads = 256;
constexpr int kMaxChunks = 32;

// output tile at H/4
constexpr int TH = 8, TW = 16;
// each level's region of a tile: rows x columns
constexpr int N_R = 4 * TH + 9, N_C = 4 * TW + 9;    // normalized frame
constexpr int A1_R = 4 * TH + 7, A1_C = 4 * TW + 7;  // conv1, H x W
constexpr int A1_E = (A1_C + 1) / 2;                 // its even columns
constexpr int A2_R = 2 * TH + 3, A2_C = 2 * TW + 3;  // conv2, H/2
constexpr int A3_R = 2 * TH + 1, A3_C = 2 * TW + 1;  // conv3, H/2
constexpr int A3_E = (A3_C + 1) / 2;
// the strips of rows a thread computes in conv1, conv2, conv3 and conv4
constexpr int R1 = 13, R2 = 3, R3 = 3, R4 = 4;
static_assert(A1_R % R1 == 0, "conv1 strips cover its rows exactly");
static_assert(TH % R4 == 0, "conv4 strips cover the tile's rows");

// shared memory, in floats
constexpr int kRegion1 = A1_R * A1_C * 4;  // conv1, then conv3
constexpr int kRegion2 = A2_R * A2_C * 8;  // the frame, conv2, the output
static_assert(A3_R * A3_C * 8 <= kRegion1, "conv3 fits conv1's region");
static_assert(N_R * N_C <= kRegion2, "the frame fits conv2's region");
static_assert(TH * TW * 24 <= kRegion2, "the output fits conv2's region");
// weights in shared memory: conv2, conv3, conv4 as [tap][cin][cout], biases
constexpr int kW2 = 0, kB2 = kW2 + 9 * 4 * 8, kW3 = kB2 + 8;
constexpr int kB3 = kW3 + 9 * 8 * 8, kW4 = kB3 + 8, kB4 = kW4 + 9 * 8 * 24;
constexpr int kWeights = kB4 + 24;
constexpr int kPool = TH * TW;  // the skip's pooled frame; first the chunks
static_assert(2 * kMaxChunks <= kPool, "the chunk sums fit the pool");
constexpr int kSmemFloats = kRegion1 + kRegion2 + kWeights + kPool + 4;
constexpr int kSmemBytes = kSmemFloats * (int)sizeof(float);
static_assert(kRegion1 % 4 == 0 && kRegion2 % 4 == 0 && kW3 % 4 == 0 &&
                  kW4 % 4 == 0 && kWeights % 4 == 0,
              "float4 alignment of every array");

// the frame's region loaded per thread
constexpr int kLoads = (N_R * N_C + kThreads - 1) / kThreads;

// conv1, conv2, conv3, conv4 (3x3) and the skip (1x1): weight and bias
// pointers and each weight's strides (cout, cin, ky, kx) in floats
struct StemWeights {
  const float* w[5];
  const float* b[5];
  int s[5][4];
};

__device__ __forceinline__ float4 relu4(float a, float b, float c, float d) {
  return make_float4(fmaxf(a, 0.f), fmaxf(b, 0.f), fmaxf(c, 0.f),
                     fmaxf(d, 0.f));
}

// acc[o] += v.c * w[c][o] for the 4 input channels c in turn (one FMA
// each), w as float4 rows of NO = 4 or 8 outputs
template <int NO>
__device__ __forceinline__ void mac4(float* acc, float4 v, const float4* w) {
  constexpr int Q = NO / 4;
  const float vc[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int c = 0; c < 4; ++c)
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      const float4 wq = w[c * Q + q];
      acc[4 * q + 0] += vc[c] * wq.x;
      acc[4 * q + 1] += vc[c] * wq.y;
      acc[4 * q + 2] += vc[c] * wq.z;
      acc[4 * q + 3] += vc[c] * wq.w;
    }
}

__global__ void __launch_bounds__(kStatsThreads)
    stem_stats_kernel(const float* __restrict__ x, double* __restrict__ part,
                      int HW, int S, int chunk) {
  const int s = blockIdx.x, b = blockIdx.y, t = threadIdx.x;
  const float* img = x + (size_t)b * HW;
  const int p0 = s * chunk, p1 = min(HW, p0 + chunk);
  double sum = 0.0, sq = 0.0;
  // HW and chunk are multiples of 4: whole float4s, four in flight a thread
  constexpr int kStep = 4 * kStatsThreads;
  int p = p0 + 4 * t;
  for (; p + 3 * kStep < p1; p += 4 * kStep) {
    float4 v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
      v[k] = *reinterpret_cast<const float4*>(img + p + k * kStep);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const double a = v[k].x, c = v[k].y, d = v[k].z, e = v[k].w;
      sum += a + c + d + e;
      sq += a * a + c * c + d * d + e * e;
    }
  }
  for (; p < p1; p += kStep) {
    const float4 v = *reinterpret_cast<const float4*>(img + p);
    const double a = v.x, c = v.y, d = v.z, e = v.w;
    sum += a + c + d + e;
    sq += a * a + c * c + d * d + e * e;
  }
  __shared__ double rs[kStatsThreads], rq[kStatsThreads];
  rs[t] = sum;
  rq[t] = sq;
  __syncthreads();
  for (int o = kStatsThreads / 2; o > 0; o >>= 1) {
    if (t < o) {
      rs[t] += rs[t + o];
      rq[t] += rq[t + o];
    }
    __syncthreads();
  }
  if (t == 0) {
    part[((size_t)b * S + s) * 2] = rs[0];
    part[((size_t)b * S + s) * 2 + 1] = rq[0];
  }
}

__global__ void __launch_bounds__(kThreads, kMinBlocks)
    stem_kernel(const float* __restrict__ x, const double* __restrict__ part,
                StemWeights P, float* __restrict__ out,
                float* __restrict__ unf, int H, int W, int S, int tiles_x) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float* reg1 = smem;                      // conv1, then conv3
  float* reg2 = smem + kRegion1;           // frame, conv2, output
  float* wsm = reg2 + kRegion2;            // weights
  float* pool = wsm + kWeights;            // chunk sums, then pooled frame
  float* stat = pool + kPool;              // mean, rstd
  const int t = threadIdx.x, b = blockIdx.y;
  const int H2 = H / 2, W2 = W / 2, H4 = H / 4, W4 = W / 4;
  const int Y0 = (blockIdx.x / tiles_x) * TH, X0 = (blockIdx.x % tiles_x) * TW;

  // ---- phase 0: chunk sums, weights, the raw frame region ----
  double* chunks = reinterpret_cast<double*>(pool);
  if (t < 2 * S) chunks[t] = part[(size_t)b * S * 2 + t];
  for (int i = t; i < kWeights; i += kThreads) {
    // layer l (conv2..conv4), its outputs n, and the entry's offset j in
    // the layer's [tap][cin][cout] block (the bias after it)
    const int l = i < kW3 ? 1 : i < kW4 ? 2 : 3;
    const int n = l == 3 ? 24 : 8, cin = l == 1 ? 4 : 8;
    const int j = i - (l == 1 ? kW2 : l == 2 ? kW3 : kW4);
    if (j >= 9 * cin * n) {
      wsm[i] = P.b[l][j - 9 * cin * n];
    } else {
      const int k = j / (cin * n), c = j / n % cin, o = j % n;
      const int* s = P.s[l];
      wsm[i] = P.w[l][o * s[0] + c * s[1] + (k / 3) * s[2] + (k % 3) * s[3]];
    }
  }
  const float* img = x + (size_t)b * H * W;
  const int gy0 = 4 * Y0 - 6, gx0 = 4 * X0 - 6;  // frame origin of the region
  float raw[kLoads];
#pragma unroll
  for (int k = 0; k < kLoads; ++k) {
    const int i = t + k * kThreads;
    const int gy = gy0 + i / N_C, gx = gx0 + i % N_C;
    raw[k] = (i < N_R * N_C && gy >= 0 && gy < H && gx >= 0 && gx < W)
                 ? __ldg(img + (size_t)gy * W + gx) : 0.f;
  }
  __syncthreads();
  if (t == 0) {
    double sum = 0.0, sq = 0.0;
    for (int s = 0; s < S; ++s) {
      sum += chunks[2 * s];
      sq += chunks[2 * s + 1];
    }
    const double n = (double)H * (double)W;
    const double mean = sum / n;
    const double var = fmax(sq / n - mean * mean, 0.0);
    stat[0] = (float)mean;
    stat[1] = (float)(1.0 / sqrt(var + 1e-5));
  }
  __syncthreads();
  {
    const float mean = stat[0], rstd = stat[1];
#pragma unroll
    for (int k = 0; k < kLoads; ++k) {
      const int i = t + k * kThreads;
      const int gy = gy0 + i / N_C, gx = gx0 + i % N_C;
      if (i < N_R * N_C)
        reg2[i] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                      ? (raw[k] - mean) * rstd : 0.f;
    }
  }
  __syncthreads();

  // ---- phase 1: conv1 (1 -> 4, stride 1) into reg1; the pool; the
  // space-to-depth of the tile's pixels ----
  {
    const float* nf = reg2;
    float4* a1 = reinterpret_cast<float4*>(reg1);
    float w1[4][9], b1[4];
    {
      const int* s = P.s[0];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        b1[o] = __ldg(P.b[0] + o);
#pragma unroll
        for (int k = 0; k < 9; ++k)
          w1[o][k] =
              __ldg(P.w[0] + o * s[0] + (k / 3) * s[2] + (k % 3) * s[3]);
      }
    }
    for (int item = t; item < (A1_R / R1) * A1_C; item += kThreads) {
      const int j = item % A1_C, i0 = (item / A1_C) * R1;
      const int gx = 4 * X0 - 5 + j;
      const bool col_in = gx >= 0 && gx < W;
      float4* dst = a1 + (j & 1 ? A1_E + (j >> 1) : j >> 1);
      const float* src = nf + i0 * N_C + j;
      float r0[3], r1[3];
#pragma unroll
      for (int kx = 0; kx < 3; ++kx) {
        r0[kx] = src[kx];
        r1[kx] = src[N_C + kx];
      }
#pragma unroll
      for (int r = 0; r < R1; ++r) {
        float r2[3];
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) r2[kx] = src[(r + 2) * N_C + kx];
        float acc[4];
#pragma unroll
        for (int o = 0; o < 4; ++o) {
          float a = b1[o];
#pragma unroll
          for (int kx = 0; kx < 3; ++kx) {
            a += r0[kx] * w1[o][kx];
            a += r1[kx] * w1[o][3 + kx];
            a += r2[kx] * w1[o][6 + kx];
          }
          acc[o] = a;
        }
        const int gy = 4 * Y0 - 5 + i0 + r;
        dst[(i0 + r) * A1_C] = (col_in && gy >= 0 && gy < H)
                                   ? relu4(acc[0], acc[1], acc[2], acc[3])
                                   : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          r0[kx] = r1[kx];
          r1[kx] = r2[kx];
        }
      }
    }
    // the skip's 4x4 average pool of the tile's output positions
    if (t < TH * TW) {
      const int ty = t / TW, tx = t % TW;
      const float* src = nf + (6 + 4 * ty) * N_C + 6 + 4 * tx;
      float s = 0.f;
#pragma unroll
      for (int dy = 0; dy < 4; ++dy)
#pragma unroll
        for (int dx = 0; dx < 4; ++dx) s += src[dy * N_C + dx];
      pool[t] = s * 0.0625f;
    }
    // space-to-depth, (B, 64, H/8, W/8) contiguous as pixel_unshuffle
    // gives it on CUDA: cell (cy, cx) takes pixel (8cy + i, 8cx + j) as
    // channel 8i + j; a thread writes four cells of one channel's row (W/8
    // and the tile's first cell are multiples of 4)
    const int H8 = H / 8, W8 = W / 8;
    for (int item = t; item < 64 * (TH / 2) * (TW / 8); item += kThreads) {
      const int q = item % (TW / 8), cyl = item / (TW / 8) % (TH / 2);
      const int c = item / (TW / 8 * (TH / 2));
      const int cy = Y0 / 2 + cyl, cx = X0 / 2 + 4 * q;
      if (cy >= H8 || cx >= W8) continue;
      const float* src = nf + (6 + 8 * cyl + c / 8) * N_C + 6 + 32 * q + c % 8;
      *reinterpret_cast<float4*>(
          unf + (((size_t)b * 64 + c) * H8 + cy) * W8 + cx) =
          make_float4(src[0], src[8], src[16], src[24]);
    }
  }
  __syncthreads();

  // ---- phase 2: conv2 (4 -> 8, stride 2) from reg1 into reg2 ----
  {
    const float4* a1 = reinterpret_cast<const float4*>(reg1);
    float4* a2 = reinterpret_cast<float4*>(reg2);
    const float4* w2 = reinterpret_cast<const float4*>(wsm + kW2);
    constexpr int strips = (A2_R + R2 - 1) / R2;
    for (int item = t; item < strips * A2_C; item += kThreads) {
      const int j = item % A2_C;
      const int i0 = min((item / A2_C) * R2, A2_R - R2);
      float acc[R2][8];
#pragma unroll
      for (int r = 0; r < R2; ++r)
#pragma unroll
        for (int o = 0; o < 8; ++o) acc[r][o] = wsm[kB2 + o];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx) {
          const float4* w = w2 + (ky * 3 + kx) * 8;
          const float4* src = a1 + (2 * i0 + ky) * A1_C +
                              (kx == 1 ? A1_E + j : j + kx / 2);
#pragma unroll
          for (int r = 0; r < R2; ++r) mac4<8>(acc[r], src[2 * r * A1_C], w);
        }
      const int gx = 2 * X0 - 2 + j;
#pragma unroll
      for (int r = 0; r < R2; ++r) {
        const int gy = 2 * Y0 - 2 + i0 + r;
        const bool in = gx >= 0 && gx < W2 && gy >= 0 && gy < H2;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        a2[(i0 + r) * A2_C + j] =
            in ? relu4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]) : z;
        a2[(A2_R + i0 + r) * A2_C + j] =
            in ? relu4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]) : z;
      }
    }
  }
  __syncthreads();

  // ---- phase 3: conv3 (8 -> 8, stride 1) from reg2 into reg1 ----
  {
    const float4* a2 = reinterpret_cast<const float4*>(reg2);
    float4* a3 = reinterpret_cast<float4*>(reg1);
    const float4* w3 = reinterpret_cast<const float4*>(wsm + kW3);
    constexpr int strips = (A3_R + R3 - 1) / R3;
    for (int item = t; item < strips * A3_C; item += kThreads) {
      const int j = item % A3_C;
      const int i0 = min((item / A3_C) * R3, A3_R - R3);
      float acc[R3][8];
#pragma unroll
      for (int r = 0; r < R3; ++r)
#pragma unroll
        for (int o = 0; o < 8; ++o) acc[r][o] = wsm[kB3 + o];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            const float4* w = w3 + (ky * 3 + kx) * 16 + h * 8;
            const float4* src = a2 + (h * A2_R + i0 + ky) * A2_C + j + kx;
#pragma unroll
            for (int r = 0; r < R3; ++r) mac4<8>(acc[r], src[r * A2_C], w);
          }
      const int gx = 2 * X0 - 1 + j;
      const int jj = j & 1 ? A3_E + (j >> 1) : j >> 1;
#pragma unroll
      for (int r = 0; r < R3; ++r) {
        const int gy = 2 * Y0 - 1 + i0 + r;
        const bool in = gx >= 0 && gx < W2 && gy >= 0 && gy < H2;
        const float4 z = make_float4(0.f, 0.f, 0.f, 0.f);
        a3[(i0 + r) * A3_C + jj] =
            in ? relu4(acc[r][0], acc[r][1], acc[r][2], acc[r][3]) : z;
        a3[(A3_R + i0 + r) * A3_C + jj] =
            in ? relu4(acc[r][4], acc[r][5], acc[r][6], acc[r][7]) : z;
      }
    }
  }
  __syncthreads();

  // ---- phase 4: conv4 (8 -> 24, stride 2) from reg1, + bias, ReLU, + the
  // skip; staged in reg2 as the output's rows ----
  {
    const float4* a3 = reinterpret_cast<const float4*>(reg1);
    float* stage = reg2;
    const float4* w4 = reinterpret_cast<const float4*>(wsm + kW4);
    constexpr int quads = TH / R4;
    if (t < 6 * quads * TW) {
      const int tx = t % TW, rq = (t / TW) % quads, cg = t / (TW * quads);
      float acc[R4][4];
#pragma unroll
      for (int r = 0; r < R4; ++r)
#pragma unroll
        for (int o = 0; o < 4; ++o) acc[r][o] = wsm[kB4 + 4 * cg + o];
#pragma unroll
      for (int ky = 0; ky < 3; ++ky)
#pragma unroll
        for (int kx = 0; kx < 3; ++kx)
#pragma unroll
          for (int h = 0; h < 2; ++h) {
            // [tap][cin][cout] rows of 24 = 6 float4: cin 4h..4h+3, couts
            // 4cg..4cg+3
            float4 w[4];
#pragma unroll
            for (int c = 0; c < 4; ++c)
              w[c] = w4[((ky * 3 + kx) * 8 + 4 * h + c) * 6 + cg];
            const float4* src = a3 + (h * A3_R + 2 * R4 * rq + ky) * A3_C +
                                (kx == 1 ? A3_E + tx : tx + kx / 2);
#pragma unroll
            for (int r = 0; r < R4; ++r) mac4<4>(acc[r], src[2 * r * A3_C], w);
          }
      float ws[4], bs[4];
#pragma unroll
      for (int o = 0; o < 4; ++o) {
        ws[o] = __ldg(P.w[4] + (4 * cg + o) * P.s[4][0]);
        bs[o] = __ldg(P.b[4] + 4 * cg + o);
      }
#pragma unroll
      for (int r = 0; r < R4; ++r) {
        const int ty = R4 * rq + r;
        const float p = pool[ty * TW + tx];
        float v[4];
#pragma unroll
        for (int o = 0; o < 4; ++o)
          v[o] = fmaxf(acc[r][o], 0.f) + (bs[o] + ws[o] * p);
        *reinterpret_cast<float4*>(stage + (ty * TW + tx) * 24 + 4 * cg) =
            make_float4(v[0], v[1], v[2], v[3]);
      }
    }
    __syncthreads();
    // the tile's rows: (TW or fewer columns) x 24 channels each, contiguous
    // in the channels-last output
    const int cols = min(TW, W4 - X0);
    const int row4 = cols * 6;  // float4s of a row
    for (int i = t; i < TH * TW * 6; i += kThreads) {
      const int ty = i / (TW * 6), k = i % (TW * 6);
      if (k >= row4 || Y0 + ty >= H4) continue;
      *reinterpret_cast<float4*>(
          out + (((size_t)b * H4 + Y0 + ty) * W4 + X0) * 24 + 4 * k) =
          reinterpret_cast<const float4*>(stage + ty * TW * 24)[k];
    }
  }
}

// Allow the stem kernel its shared memory and the largest carveout, once
// per device.
cudaError_t allow_smem() {
  static std::atomic<unsigned long long> done{0};  // a bit per device
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned long long bit = dev < 64 ? 1ull << dev : 0ull;
  if (done.load() & bit) return cudaSuccess;
  err = cudaFuncSetAttribute(stem_kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(stem_kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               (int)cudaSharedmemCarveoutMaxShared);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

}  // namespace

// The chunks a frame of HW pixels is summed in (launch 1's grid is B x S)
// and the pixels of each, a multiple of 4.
extern "C" int xfeat_stem_chunks(int B, int HW, int* chunk) {
  int S = (528 + B - 1) / B;  // four CTAs per SM at the least
  S = S < 1 ? 1 : (S > kMaxChunks ? kMaxChunks : S);
  int c = (HW + S - 1) / S;
  c = (c + 3) / 4 * 4;
  *chunk = c;
  return (HW + c - 1) / c;
}

// Resident CTAs of the stem kernel per SM (-1 on error).
extern "C" int xfeat_stem_occupancy() {
  if (allow_smem() != cudaSuccess) return -1;
  int n = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, stem_kernel, kThreads,
                                                    kSmemBytes) != cudaSuccess)
    return -1;
  return n;
}

// x: (B, H, W) float32 frames, H and W multiples of 32; part: (B, S, 2)
// float64 scratch; w, b: host arrays of the 5 convs' weight and bias device
// pointers (conv1..conv4, skip); strides: host array of 5 x 4 weight
// strides; out: (B, H/4, W/4, 24) float32; unf: (B, 64, H/8, W/8) float32.
extern "C" int xfeat_stem(const float* x, double* part, const void* const* w,
                          const void* const* b, const int* strides, float* out,
                          float* unf, int B, int H, int W, int S, int chunk,
                          void* stream) {
  if (B < 1 || H < 32 || W < 32 || H % 32 || W % 32 || S < 1 ||
      S > kMaxChunks)
    return (int)cudaErrorInvalidValue;
  StemWeights P;
  for (int l = 0; l < 5; ++l) {
    P.w[l] = static_cast<const float*>(w[l]);
    P.b[l] = static_cast<const float*>(b[l]);
    for (int k = 0; k < 4; ++k) P.s[l][k] = strides[4 * l + k];
  }
  cudaError_t err = allow_smem();
  if (err != cudaSuccess) return (int)err;
  const cudaStream_t st = (cudaStream_t)stream;
  stem_stats_kernel<<<dim3(S, B), kStatsThreads, 0, st>>>(x, part, H * W, S,
                                                          chunk);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W / 4 + TW - 1) / TW, tiles_y = (H / 4 + TH - 1) / TH;
  stem_kernel<<<dim3(tiles_x * tiles_y, B), kThreads, kSmemBytes, st>>>(
      x, part, P, out, unf, H, W, S, tiles_x);
  return (int)cudaGetLastError();
}
