// Bundle adjustment (robust LM + block-Jacobi PCG over cameras and points)
// as a fixed sequence of hand-written kernels.
//
// Replaces xfeatslam_tpu/optim/local_ba.py bundle_adjust (:102-284), which
// is XLA code, not Pallas: two fori_loops (LM iterations, CG steps,
// :212-258) of gathers and segment sums in one jitted program. Its
// PyTorch counterpart (optim/local_ba.bundle_adjust_plain) replays that
// arithmetic as ~80 small ATen kernels per CG step, ~16,400 per round of 5
// LM iterations; this file does a round in 431 launches.
//
// What it computes, as the plain version does. C cameras (R, t), P points
// X, O observations (camera, point, uv, ur, stereo, valid, inv_sigma2).
// Residual e = [u - u', v - v', ur - (u' - bf/z)] with the depth clamped
// to 1e-6 (1e-9 in the projection's Jacobian), chi2 = (e0^2 + e1^2) s
// (+ e2^2 s for stereo), Huber at 5.991 / 7.815 with the 1e-12 clamp.
// Two stages of LM iterations (stage_iters), the second on the
// observations the first leaves with chi2 <= delta2 and positive depth.
// An iteration: weights w = huber(chi2) s active, the gradient g and the
// block diagonals Hcc (6x6) and Hpp (3x3) per camera and per point, their
// damped inverses (H + (lam diag + 1e-6) I, identity on fixed or padded
// entries), cg_iters steps of PCG on (H + lam D) dx = -g with the 1e-12
// guards on pAp and rz, the left-multiplicative update exp(xc) T on free
// cameras and X + xp on valid points, the trial cost, accept when it
// falls and both steps are finite (lam * 0.5), else reject (lam * 4);
// lam starts at 1e-4 in each stage. Outputs: poses, points, chi2 and
// inlier = valid & chi2 <= delta2 & depth > 0.
//
// What bounds it on an H100: on paper, bytes per CG step. One step reads
// the stored linearization (33 floats per observation, ~2.2 MB for the
// 16,384 observations of a full local-BA bucket) twice, from L2: about a
// microsecond. In practice the chain of dependent launches, 2 per CG step,
// each a few microseconds of L2 latency, barriers and launch: a CG step's
// matrix-free product takes ~10 us, its update ~4 us.
//
// Design. k_init copies the state and indexes the SegmentPlan once per
// solve: a camera's observations fill consecutive "slots" (the rows of
// its chunks), and k_index lists each point's slots and cameras. Once per
// LM iteration k_linearize writes Jc, Jp, the row weights and e per slot
// (33 arrays over the slots, so a camera's rows are read by consecutive
// threads at consecutive addresses), then k_normal sums g and the block
// diagonals, inverts the damped blocks and starts PCG. One CG step is two
// launches over the "entity grid" (one CTA per camera, then one per 256
// points):
//   k_hv: p = z + beta p_old for the CTA's own entities (beta from the
//     previous step's rz partials, summed by every CTA in one fixed
//     order), written to the other of two p buffers; the matrix-free
//     (H + lam D) p, a camera CTA over its observations in plan order, a
//     point CTA with kLanes threads per point computing the terms of the
//     point's observations in parallel and its first lane adding them in
//     order; each side recomputes the other side's p from z and p_old;
//     pAp partials.
//   k_step: alpha from the partials, x += alpha p, r -= alpha Ap,
//     z = M^-1 r, rz partials (ping-pong by step parity).
// The trial update, its cost and the accept take three launches; lam and
// the carried cost live in device memory, one slot per iteration. The
// host issues the whole sequence and reads nothing, so a CUDA graph
// captures it. No atomics: every sum has one fixed order (a thread's, or
// a point's first lane's, terms in plan order, then a fixed pairwise tree
// over 256 values), so two solves, and a replay and an eager call, give
// the same bits. Launched on the caller's stream; all memory comes from
// the caller.

#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;  // a CTA's entities and reduction width
constexpr unsigned kFull = 0xffffffffu;
// k_hv's point CTAs give each point kLanes threads (its observations spread
// over them); its CTAs are kThreads * kLanes threads
constexpr int kLanes = 4;
constexpr int kHvThreads = kThreads * kLanes;
constexpr int kChunk = 128;    // SegmentPlan chunk rows (SEGMENT_CHUNK)
constexpr int kLin = 36;       // floats per observation of the linearization
// the row's layout: Jc (3x6), Jp (3x3), row weights (3), e (3)
constexpr int kJp = 18, kWr = 27, kE = 30;
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;

struct Problem {
  const float* R;               // (C,3,3)
  const float* t;               // (C,3)
  const unsigned char* fixed;   // (C,)
  const unsigned char* cam_valid;
  const float* X;               // (P,3)
  const unsigned char* p_valid;
  const int* obs_cam;           // (O,)
  const int* obs_pt;
  const float* uv;              // (O,2)
  const float* ur;
  const unsigned char* stereo;
  const unsigned char* valid;
  const float* isig;
  const long long* cam_rows;    // (NCH, kChunk)
  const long long* cam_chunks;  // (C, NW)
  const long long* pt_rows;     // (P, PW)
  int C, P, O, NCH, NW, PW;
  float fx, fy, cx, cy, bf;
  int huber;
};

// Device state, carved from the caller's scratch (see carve()).
struct State {
  float *R, *t, *X;     // the current solution: the outputs
  float *Rn, *tn, *Xn;  // the trial
  float* lin;           // (kLin, NS): observation slots in plan order
  int* slot_of;         // (O,) an observation's slot (valid ones)
  int* slot_pt;         // (NS,) a slot's point, -1 for an empty slot
  int* pt_slot;         // (P, PW) the slots of a point's observations
  int* pt_cam;          // (P, PW) and their cameras
  int* pt_n;            // (P,) how many
  float *Mc, *dc, *Mp, *dp;
  float *xc, *xp, *rc, *rp, *zc, *zp, *Apc, *App;
  float *pc[2], *pp[2];
  float* pap;           // (NB,) partials of p.Ap
  float* rz[2];         // (NB,) partials of r.z, by step parity
  float* fin;           // (NB,) 1 where the CTA's steps are finite
  float* cost;          // (NBO,) partials of a robust cost
  float* lam;           // one slot per LM iteration of a stage
  float* cost0;
  float* act;           // (O,) 1 for the stage's active observations
  unsigned char* inlier;
  float* chi2;
  int NB, NBO;
  long long NS;         // slots: NCH x kChunk, the rows of cam_rows
};

// Observation slot `slot`'s linearization: entry k is lin[k * NS + slot]
// (kLin arrays over the slots, so a camera's rows, which fill consecutive
// slots of its chunks, are read by consecutive threads at consecutive
// addresses).
struct Row {
  float* base;
  long long stride;
  __device__ __forceinline__ float& operator[](int k) const {
    return base[k * stride];
  }
};

__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;  // keeps a NaN, as torch's clamp
}

__device__ __forceinline__ float safe_inv(float z, float eps) {
  return 1.f / (fabsf(z) < eps ? eps : z);
}

__device__ __forceinline__ float guard(float x) {
  return fabsf(x) < 1e-12f ? 1e-12f : x;
}

__device__ __forceinline__ float free_cam(const Problem& p, int c) {
  return (!p.fixed[c] && p.cam_valid[c]) ? 1.f : 0.f;
}

__device__ __forceinline__ float valid_pt(const Problem& p, int q) {
  return p.p_valid[q] ? 1.f : 0.f;
}

__device__ __forceinline__ float delta2(const Problem& p, int o) {
  return p.stereo[o] ? kChi2Stereo : kChi2Mono;
}

__device__ __forceinline__ float robust_cost(const Problem& p, float chi2,
                                             float d2) {
  if (!p.huber) return chi2;
  return chi2 <= d2 ? chi2 : 2.f * sqrtf(d2 * clamp_min(chi2, 0.f)) - d2;
}

// Observation o at camera pose (R, t) and point X: e, chi2 and the camera
// frame point.
struct Eval {
  float x, y, z, iz6;
  float e[3];
  float chi2;
};

__device__ Eval evaluate(const Problem& p, int o, const float* R,
                         const float* t, const float* X) {
  Eval v;
  v.x = R[0] * X[0] + R[1] * X[1] + R[2] * X[2] + t[0];
  v.y = R[3] * X[0] + R[4] * X[1] + R[5] * X[2] + t[1];
  v.z = R[6] * X[0] + R[7] * X[1] + R[8] * X[2] + t[2];
  v.iz6 = safe_inv(v.z, 1e-6f);
  const float u = p.fx * v.x * v.iz6 + p.cx;
  const float vv = p.fy * v.y * v.iz6 + p.cy;
  v.e[0] = p.uv[2 * o] - u;
  v.e[1] = p.uv[2 * o + 1] - vv;
  v.e[2] = p.ur[o] - (u - p.bf * v.iz6);
  const float s = p.isig[o];
  const float mono = (v.e[0] * v.e[0] + v.e[1] * v.e[1]) * s;
  v.chi2 = p.stereo[o] ? mono + v.e[2] * v.e[2] * s : mono;
  return v;
}

__device__ __forceinline__ Eval evaluate_at(const Problem& p, int o,
                                            const float* R, const float* t,
                                            const float* X) {
  const int c = p.obs_cam[o], q = p.obs_pt[o];
  return evaluate(p, o, R + 9 * c, t + 3 * c, X + 3 * q);
}

// Sums red[k * kThreads + t] over t < kThreads in a fixed tree (pairs t,
// t + s for s = 128, 64, ..., 1), red written and synced before the call;
// the last five levels run in warp 0 by shuffles, which add the same pairs
// in the same order. The totals are red[k * kThreads] on return (all
// threads synced).
template <int K>
__device__ void block_tree(float* red) {
  const int tid = threadIdx.x;
  for (int s = kThreads / 2; s >= 32; s >>= 1) {
    if (tid < s)
      for (int k = 0; k < K; ++k)
        red[k * kThreads + tid] += red[k * kThreads + tid + s];
    __syncthreads();
  }
  if (tid < 32) {
    for (int k = 0; k < K; ++k) {
      float x = red[k * kThreads + tid];
#pragma unroll
      for (int s = 16; s > 0; s >>= 1) x += __shfl_down_sync(kFull, x, s);
      if (tid == 0) red[k * kThreads] = x;
    }
  }
  __syncthreads();
}

// block_tree of one value per thread of the first kThreads (a larger CTA's
// other threads only take part in the barriers).
template <int K>
__device__ void block_sum(const float (&v)[K], float* red) {
  if (threadIdx.x < kThreads)
    for (int k = 0; k < K; ++k) red[k * kThreads + threadIdx.x] = v[k];
  __syncthreads();
  block_tree<K>(red);
}

// The sum of a[0..n) in one fixed order (each thread's stride, then the
// tree): every CTA that calls it gets the same bits. red: kThreads floats.
__device__ float sum_partials(const float* a, int n, float* red) {
  float s = 0.f;
  if (threadIdx.x < kThreads)
    for (int i = threadIdx.x; i < n; i += kThreads) s += a[i];
  const float v[1] = {s};
  block_sum<1>(v, red);
  const float total = red[0];
  __syncthreads();
  return total;
}

// sum_partials of a and of b at once (the same trees; red: 2 * kThreads).
__device__ void sum_partials2(const float* a, const float* b, int n,
                              float* red, float& sa, float& sb) {
  float v[2] = {0.f, 0.f};
  if (threadIdx.x < kThreads)
    for (int i = threadIdx.x; i < n; i += kThreads) {
      v[0] += a[i];
      v[1] += b[i];
    }
  block_sum<2>(v, red);
  sa = red[0];
  sb = red[kThreads];
  __syncthreads();
}

// Inverse by Gauss-Jordan elimination with partial pivoting (one thread).
template <int N>
__device__ void invert(float (&A)[N][N], float* out) {
  float B[N][N];
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) B[i][j] = i == j ? 1.f : 0.f;
  for (int col = 0; col < N; ++col) {
    int piv = col;
    float best = fabsf(A[col][col]);
    for (int r = col + 1; r < N; ++r)
      if (fabsf(A[r][col]) > best) {
        best = fabsf(A[r][col]);
        piv = r;
      }
    if (piv != col)
      for (int j = 0; j < N; ++j) {
        float a = A[col][j];
        A[col][j] = A[piv][j];
        A[piv][j] = a;
        float b = B[col][j];
        B[col][j] = B[piv][j];
        B[piv][j] = b;
      }
    const float d = 1.f / A[col][col];
    for (int j = 0; j < N; ++j) {
      A[col][j] *= d;
      B[col][j] *= d;
    }
    for (int r = 0; r < N; ++r) {
      if (r == col) continue;
      const float f = A[r][col];
      for (int j = 0; j < N; ++j) {
        A[r][j] -= f * A[col][j];
        B[r][j] -= f * B[col][j];
      }
    }
  }
  for (int i = 0; i < N; ++i)
    for (int j = 0; j < N; ++j) out[N * i + j] = B[i][j];
}

// The slot of camera c's j-th observation in plan order, -1 past its last
// chunk; a slot of that chunk beyond its last row is empty (slot_pt -1,
// skipped by the caller).
__device__ __forceinline__ long long cam_slot(const Problem& p, int c,
                                              int j) {
  const int k = j / kChunk;
  if (k >= p.NW) return -1;
  const long long chunk = p.cam_chunks[(long long)c * p.NW + k];
  if (chunk >= p.NCH) return -1;
  return chunk * kChunk + j % kChunk;
}

// ---------------------------------------------------------------------------
// kernels

// The state starts at the problem's poses and points; stage 1's active
// set is the valid observations; each slot's point and each valid
// observation's slot. A grid-stride pass.
__global__ void k_init(Problem p, State s) {
  long long n = max(max(p.C * 9, p.P * 3), p.O);
  if (s.NS > n) n = s.NS;
  for (long long i = blockIdx.x * kThreads + threadIdx.x; i < n;
       i += gridDim.x * kThreads) {
    if (i < p.C * 9) s.R[i] = p.R[i];
    if (i < p.C * 3) s.t[i] = p.t[i];
    if (i < p.P * 3) s.X[i] = p.X[i];
    if (i < p.O) s.act[i] = p.valid[i] ? 1.f : 0.f;
    if (i < s.NS) {
      const long long o = p.cam_rows[i];
      s.slot_pt[i] = o < p.O ? p.obs_pt[o] : -1;
      if (o < p.O) s.slot_of[o] = (int)i;
    }
  }
}

// Partials of the robust cost over the active observations, at the
// current solution or at the trial (one per CTA of the observation grid).
__global__ void k_cost(Problem p, State s, int trial) {
  __shared__ float red[kThreads];
  const int o = blockIdx.x * kThreads + threadIdx.x;
  float c = 0.f;
  if (o < p.O) {
    const Eval v = trial ? evaluate_at(p, o, s.Rn, s.tn, s.Xn)
                         : evaluate_at(p, o, s.R, s.t, s.X);
    c = s.act[o] != 0.f ? robust_cost(p, v.chi2, delta2(p, o)) : 0.f;
  }
  const float vals[1] = {c};
  block_sum<1>(vals, red);
  if (threadIdx.x == 0) s.cost[blockIdx.x] = red[0];
}

// A stage's start: the carried cost and lam = 1e-4 (one CTA).
__global__ void k_stage_init(State s) {
  __shared__ float red[kThreads];
  const float c = sum_partials(s.cost, s.NBO, red);
  if (threadIdx.x == 0) {
    s.cost0[0] = c;
    s.lam[0] = 1e-4f;
  }
}

// The linearization at the current solution: Jc, Jp (the plain version's
// signs), the row weights w (1, 1, stereo) with w = huber(chi2) s active,
// and e. A thread per slot.
__global__ void k_linearize(Problem p, State s) {
  const long long slot = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (slot >= s.NS) return;
  const long long ol = p.cam_rows[slot];
  if (ol >= p.O) return;
  const int o = (int)ol;
  const int c = p.obs_cam[o];
  const float* R = s.R + 9 * c;
  const Eval v = evaluate(p, o, R, s.t + 3 * c, s.X + 3 * p.obs_pt[o]);
  const float d2 = delta2(p, o);
  float w = 1.f;
  if (p.huber)
    w = v.chi2 <= d2 ? 1.f : sqrtf(d2 / clamp_min(v.chi2, 1e-12f));
  w = w * p.isig[o] * s.act[o];
  const float iz = safe_inv(v.z, 1e-9f), iz2 = iz * iz;
  // d(u, v, ur)/dXc
  float J[3][3] = {{p.fx * iz, 0.f, -p.fx * v.x * iz2},
                   {0.f, p.fy * iz, -p.fy * v.y * iz2},
                   {p.fx * iz, 0.f, -p.fx * v.x * iz2}};
  J[2][2] = J[2][2] + p.bf * v.iz6 * v.iz6;
  const Row row{s.lin + slot, s.NS};
  for (int r = 0; r < 3; ++r) {
    // Jc = -J [I | -hat(Xc)], Jp = -J R
    row[6 * r + 0] = -J[r][0];
    row[6 * r + 1] = -J[r][1];
    row[6 * r + 2] = -J[r][2];
    row[6 * r + 3] = J[r][1] * v.z - J[r][2] * v.y;
    row[6 * r + 4] = J[r][2] * v.x - J[r][0] * v.z;
    row[6 * r + 5] = J[r][0] * v.y - J[r][1] * v.x;
    for (int k = 0; k < 3; ++k)
      row[kJp + 3 * r + k] =
          -(J[r][0] * R[k] + J[r][1] * R[3 + k] + J[r][2] * R[6 + k]);
    row[kE + r] = v.e[r];
  }
  row[kWr] = w;
  row[kWr + 1] = w;
  row[kWr + 2] = p.stereo[o] ? w : 0.f;
}

// g and the block diagonals per camera and per point, the damped
// inverses, and the start of PCG: x = 0, r = -g, z = M^-1 r, rz partials
// (parity 0). Entity grid.
__global__ void k_normal(Problem p, State s, int it) {
  __shared__ float red[27 * kThreads];
  const int b = blockIdx.x, tid = threadIdx.x;
  const float lam = s.lam[it];
  if (b < p.C) {
    const int c = b;
    float acc[27];
    for (int k = 0; k < 27; ++k) acc[k] = 0.f;
    for (int j = tid;; j += kThreads) {
      const long long slot = cam_slot(p, c, j);
      if (slot < 0) break;
      if (s.slot_pt[slot] < 0) continue;
      const Row row{s.lin + slot, s.NS};
      for (int r = 0; r < 3; ++r) {
        const float wr = row[kWr + r], e = row[kE + r];
        int k = 6;
#pragma unroll
        for (int i = 0; i < 6; ++i) {
          const float jw = row[6 * r + i] * wr;
          acc[i] += jw * e;
#pragma unroll
          for (int m = i; m < 6; ++m) acc[k++] += jw * row[6 * r + m];
        }
      }
    }
    block_sum<27>(acc, red);
    if (tid == 0) {
      const float f = free_cam(p, c);
      float H[6][6], g[6];
      int k = 6;
      for (int i = 0; i < 6; ++i) {
        g[i] = red[i * kThreads] * f;
        for (int m = i; m < 6; ++m) {
          H[i][m] = H[m][i] = red[(k++) * kThreads];
        }
      }
      for (int i = 0; i < 6; ++i) s.dc[6 * c + i] = lam * H[i][i] + 1e-6f;
      for (int i = 0; i < 6; ++i)
        for (int m = 0; m < 6; ++m)
          H[i][m] = f != 0.f ? H[i][m] + (i == m ? s.dc[6 * c + i] : 0.f)
                             : (i == m ? 1.f : 0.f);
      float* M = s.Mc + 36 * c;
      invert<6>(H, M);
      float rz = 0.f;
      for (int i = 0; i < 6; ++i) {
        s.xc[6 * c + i] = 0.f;
        s.rc[6 * c + i] = -g[i];
      }
      for (int i = 0; i < 6; ++i) {
        float z = 0.f;
        for (int m = 0; m < 6; ++m) z += M[6 * i + m] * -g[m];
        z = z * f;
        s.zc[6 * c + i] = z;
        rz += -g[i] * z;
      }
      s.rz[0][b] = rz;
    }
  } else {
    const int q = (b - p.C) * kThreads + tid;
    float rz = 0.f;
    if (q < p.P) {
      float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      const long long base = (long long)q * p.PW;
      const int n = s.pt_n[q];
#pragma unroll 2
      for (int j = 0; j < n; ++j) {
        const Row row{s.lin + s.pt_slot[base + j], s.NS};
        for (int r = 0; r < 3; ++r) {
          const float wr = row[kWr + r], e = row[kE + r];
          int k = 3;
#pragma unroll
          for (int i = 0; i < 3; ++i) {
            const float jw = row[kJp + 3 * r + i] * wr;
            acc[i] += jw * e;
#pragma unroll
            for (int m = i; m < 3; ++m) acc[k++] += jw * row[kJp + 3 * r + m];
          }
        }
      }
      const float f = valid_pt(p, q);
      float H[3][3], g[3];
      int k = 3;
      for (int i = 0; i < 3; ++i) {
        g[i] = acc[i] * f;
        for (int m = i; m < 3; ++m) H[i][m] = H[m][i] = acc[k++];
      }
      for (int i = 0; i < 3; ++i) s.dp[3 * q + i] = lam * H[i][i] + 1e-6f;
      for (int i = 0; i < 3; ++i)
        for (int m = 0; m < 3; ++m)
          H[i][m] = f != 0.f ? H[i][m] + (i == m ? s.dp[3 * q + i] : 0.f)
                             : (i == m ? 1.f : 0.f);
      float* M = s.Mp + 9 * q;
      invert<3>(H, M);
      for (int i = 0; i < 3; ++i) {
        s.xp[3 * q + i] = 0.f;
        s.rp[3 * q + i] = -g[i];
      }
      for (int i = 0; i < 3; ++i) {
        float z = 0.f;
        for (int m = 0; m < 3; ++m) z += M[3 * i + m] * -g[m];
        z = z * f;
        s.zp[3 * q + i] = z;
        rz += -g[i] * z;
      }
    }
    const float v[1] = {rz};
    block_sum<1>(v, red);
    if (tid == 0) s.rz[0][b] = red[0];
  }
}

// p of CG step `step` at entry i of z / p_old: z at step 0, else
// z + beta p_old (one fused multiply-add wherever it is evaluated, so the
// owner's stored value and a reader's recomputed one are the same bits).
__device__ __forceinline__ float p_at(const float* z, const float* pold,
                                      int step, float beta, long long i) {
  return step == 0 ? z[i] : fmaf(beta, pold[i], z[i]);
}

// (H + lam D) p over the observations, with p = z + beta p_old written to
// this step's p buffer for the CTA's own entities; pAp partials. A camera
// CTA's first kThreads threads walk its observations; a point CTA's
// kLanes threads per point compute the terms of the point's observations
// in parallel, and the point's first lane adds them in observation order.
__global__ void __launch_bounds__(kHvThreads) k_hv(Problem p, State s,
                                                   int step) {
  __shared__ float red[6 * kThreads];
  __shared__ float sbeta;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int cur = step & 1, prev = cur ^ 1;
  float beta = 0.f;
  if (step > 0) {
    float rz_new, rz_old;
    sum_partials2(s.rz[cur], s.rz[prev], s.NB, red, rz_new, rz_old);
    if (tid == 0) sbeta = rz_new / guard(rz_old);
    __syncthreads();
    beta = sbeta;
  }
  const float* pc_old = s.pc[prev];
  const float* pp_old = s.pp[prev];
  if (b < p.C) {
    const int c = b;
    const float f = free_cam(p, c);
    float vc[6], vcm[6];
    for (int i = 0; i < 6; ++i) {
      vc[i] = p_at(s.zc, pc_old, step, beta, 6 * c + i);
      vcm[i] = vc[i] * f;
    }
    float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = tid; tid < kThreads; j += kThreads) {  // kThreads walk
      const long long slot = cam_slot(p, c, j);
      if (slot < 0) break;
      const int q = s.slot_pt[slot];
      if (q < 0) continue;
      const float fq = valid_pt(p, q);
      float vp[3];
      for (int i = 0; i < 3; ++i)
        vp[i] = p_at(s.zp, pp_old, step, beta, 3 * q + i) * fq;
      const Row row{s.lin + slot, s.NS};
      for (int r = 0; r < 3; ++r) {
        float a = 0.f;
        for (int i = 0; i < 6; ++i) a += row[6 * r + i] * vcm[i];
        float d = 0.f;
        for (int i = 0; i < 3; ++i) d += row[kJp + 3 * r + i] * vp[i];
        const float rv = (a + d) * row[kWr + r];
        for (int i = 0; i < 6; ++i) h[i] += row[6 * r + i] * rv;
      }
    }
    block_sum<6>(h, red);
    if (tid == 0) {
      float pap = 0.f;
      for (int i = 0; i < 6; ++i) {
        const float ap = (red[i * kThreads] + s.dc[6 * c + i] * vc[i]) * f;
        s.Apc[6 * c + i] = ap;
        s.pc[cur][6 * c + i] = vc[i];
        pap += vc[i] * ap;
      }
      s.pap[b] = pap;
    }
  } else {
    const int t = tid / kLanes, lane = tid % kLanes;
    const int first = (tid & 31) - lane;  // the point's first lane in the warp
    const int q = (b - p.C) * kThreads + t;
    float vp[3] = {0.f, 0.f, 0.f}, vpm[3] = {0.f, 0.f, 0.f}, fq = 0.f;
    long long base = 0;
    int n = 0;
    if (q < p.P) {
      fq = valid_pt(p, q);
      for (int i = 0; i < 3; ++i) {
        vp[i] = p_at(s.zp, pp_old, step, beta, 3 * q + i);
        vpm[i] = vp[i] * fq;
      }
      base = (long long)q * p.PW;
      n = s.pt_n[q];
    }
    // rounds of kLanes observations, as many as the warp's busiest point
    int rounds = (n + kLanes - 1) / kLanes;
    for (int o = 16; o > 0; o >>= 1)
      rounds = max(rounds, __shfl_xor_sync(kFull, rounds, o));
    float h[3] = {0.f, 0.f, 0.f};
    for (int m = 0; m < rounds; ++m) {
      // this lane's observation of the round: its Jp rows and r v
      const int j = m * kLanes + lane;
      float jp[9], rv[3];
      for (int k = 0; k < 9; ++k) jp[k] = 0.f;
      for (int r = 0; r < 3; ++r) rv[r] = 0.f;
      if (j < n) {
        const int c = s.pt_cam[base + j];
        const float f = free_cam(p, c);
        float vc[6];
        for (int i = 0; i < 6; ++i)
          vc[i] = p_at(s.zc, pc_old, step, beta, 6 * c + i) * f;
        const Row row{s.lin + s.pt_slot[base + j], s.NS};
        for (int r = 0; r < 3; ++r) {
          float a = 0.f;
          for (int i = 0; i < 6; ++i) a += row[6 * r + i] * vc[i];
          float d = 0.f;
          for (int i = 0; i < 3; ++i) d += row[kJp + 3 * r + i] * vpm[i];
          rv[r] = (a + d) * row[kWr + r];
          for (int i = 0; i < 3; ++i) jp[3 * r + i] = row[kJp + 3 * r + i];
        }
      }
      // the first lane adds the round's terms in observation order
      for (int src = 0; src < kLanes; ++src) {
        float sj[9], sr[3];
        for (int k = 0; k < 9; ++k)
          sj[k] = __shfl_sync(kFull, jp[k], first + src);
        for (int r = 0; r < 3; ++r)
          sr[r] = __shfl_sync(kFull, rv[r], first + src);
        if (lane == 0 && m * kLanes + src < n)
          for (int r = 0; r < 3; ++r)
            for (int i = 0; i < 3; ++i) h[i] += sj[3 * r + i] * sr[r];
      }
    }
    if (lane == 0) {
      float pap = 0.f;
      if (q < p.P) {
        for (int i = 0; i < 3; ++i) {
          const float ap = (h[i] + s.dp[3 * q + i] * vp[i]) * fq;
          s.App[3 * q + i] = ap;
          s.pp[cur][3 * q + i] = vp[i];
          pap += vp[i] * ap;
        }
      }
      red[t] = pap;
    }
    __syncthreads();
    block_tree<1>(red);
    if (tid == 0) s.pap[b] = red[0];
  }
}

// alpha = rz / pAp; x += alpha p, r -= alpha Ap, z = M^-1 r; the next
// step's rz partials.
__global__ void k_step(Problem p, State s, int step) {
  __shared__ float red[2 * kThreads];
  __shared__ float salpha;
  const int b = blockIdx.x, tid = threadIdx.x;
  const int cur = step & 1, next = cur ^ 1;
  float rz, pap;
  sum_partials2(s.rz[cur], s.pap, s.NB, red, rz, pap);
  if (tid == 0) salpha = rz / guard(pap);
  __syncthreads();
  const float alpha = salpha;
  if (b < p.C) {
    if (tid == 0) {
      const int c = b;
      const float f = free_cam(p, c);
      float r[6];
      for (int i = 0; i < 6; ++i) {
        const int k = 6 * c + i;
        s.xc[k] = s.xc[k] + alpha * s.pc[cur][k];
        r[i] = s.rc[k] - alpha * s.Apc[k];
        s.rc[k] = r[i];
      }
      const float* M = s.Mc + 36 * c;
      float acc = 0.f;
      for (int i = 0; i < 6; ++i) {
        float z = 0.f;
        for (int m = 0; m < 6; ++m) z += M[6 * i + m] * r[m];
        z = z * f;
        s.zc[6 * c + i] = z;
        acc += r[i] * z;
      }
      s.rz[next][b] = acc;
    }
  } else {
    const int q = (b - p.C) * kThreads + tid;
    float acc = 0.f;
    if (q < p.P) {
      const float f = valid_pt(p, q);
      float r[3];
      for (int i = 0; i < 3; ++i) {
        const int k = 3 * q + i;
        s.xp[k] = s.xp[k] + alpha * s.pp[cur][k];
        r[i] = s.rp[k] - alpha * s.App[k];
        s.rp[k] = r[i];
      }
      const float* M = s.Mp + 9 * q;
      for (int i = 0; i < 3; ++i) {
        float z = 0.f;
        for (int m = 0; m < 3; ++m) z += M[3 * i + m] * r[m];
        z = z * f;
        s.zp[3 * q + i] = z;
        acc += r[i] * z;
      }
    }
    const float v[1] = {acc};
    block_sum<1>(v, red);
    if (tid == 0) s.rz[next][b] = red[0];
  }
}

// The trial: exp(xc) T on free cameras (ops/lie.se3_exp, then compose),
// X + xp on valid points; whether every step entry of the CTA is finite.
__global__ void k_update(Problem p, State s) {
  const int b = blockIdx.x, tid = threadIdx.x;
  if (b < p.C) {
    if (tid != 0) return;
    const int c = b;
    const float* dx = s.xc + 6 * c;
    const float* R = s.R + 9 * c;
    const float* t = s.t + 3 * c;
    float* Rn = s.Rn + 9 * c;
    float* tn = s.tn + 3 * c;
    bool fin = true;
    for (int i = 0; i < 6; ++i) fin = fin && isfinite(dx[i]);
    s.fin[b] = fin ? 1.f : 0.f;
    if (free_cam(p, c) == 0.f) {
      for (int k = 0; k < 9; ++k) Rn[k] = R[k];
      for (int k = 0; k < 3; ++k) tn[k] = t[k];
      return;
    }
    const float px = dx[3], py = dx[4], pz = dx[5];
    const float th2 = px * px + py * py + pz * pz;
    const float th = sqrtf(th2 + 1e-16f);
    const bool small = th2 < 1e-8f;
    const float sn = sinf(th), cs = cosf(th);
    const float a = small ? 1.f - th2 / 6.f : sn / th;
    const float bb = small ? 0.5f - th2 / 24.f : (1.f - cs) / th2;
    const float cc = small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th);
    const float Ph[9] = {0.f, -pz, py, pz, 0.f, -px, -py, px, 0.f};
    float P2[9];
    for (int m = 0; m < 3; ++m)
      for (int n = 0; n < 3; ++n)
        P2[3 * m + n] = Ph[3 * m] * Ph[n] + Ph[3 * m + 1] * Ph[3 + n] +
                        Ph[3 * m + 2] * Ph[6 + n];
    float dR[9], V[9];
    for (int k = 0; k < 9; ++k) {
      const float eye = (k % 4 == 0) ? 1.f : 0.f;
      dR[k] = eye + a * Ph[k] + bb * P2[k];
      V[k] = eye + bb * Ph[k] + cc * P2[k];
    }
    for (int m = 0; m < 3; ++m) {
      for (int n = 0; n < 3; ++n)
        Rn[3 * m + n] = dR[3 * m] * R[n] + dR[3 * m + 1] * R[3 + n] +
                        dR[3 * m + 2] * R[6 + n];
      tn[m] = (dR[3 * m] * t[0] + dR[3 * m + 1] * t[1] +
               dR[3 * m + 2] * t[2]) +
              (V[3 * m] * dx[0] + V[3 * m + 1] * dx[1] + V[3 * m + 2] * dx[2]);
    }
  } else {
    const int q = (b - p.C) * kThreads + tid;
    bool fin = true;
    if (q < p.P) {
      const bool ok = p.p_valid[q] != 0;
      for (int i = 0; i < 3; ++i) {
        const float d = s.xp[3 * q + i];
        fin = fin && isfinite(d);
        s.Xn[3 * q + i] = ok ? s.X[3 * q + i] + d : s.X[3 * q + i];
      }
    }
    const int all = __syncthreads_and(fin);
    if (tid == 0) s.fin[b] = all ? 1.f : 0.f;
  }
}

// Accept the trial when its cost is lower and every step is finite; the
// next iteration's lam and carried cost (one slot on). Entity grid.
__global__ void k_accept(Problem p, State s, int it) {
  __shared__ float red[kThreads];
  __shared__ int saccept;
  const int b = blockIdx.x, tid = threadIdx.x;
  const float cost1 = sum_partials(s.cost, s.NBO, red);
  bool fin = true;
  for (int i = tid; i < s.NB; i += kThreads) fin = fin && s.fin[i] != 0.f;
  fin = __syncthreads_and(fin) != 0;
  if (tid == 0) {
    const float cost0 = s.cost0[it];
    const bool accept = cost1 < cost0 && fin;
    saccept = accept;
    if (b == 0) {
      s.cost0[it + 1] = accept ? cost1 : cost0;
      s.lam[it + 1] = accept ? s.lam[it] * 0.5f : s.lam[it] * 4.f;
    }
  }
  __syncthreads();
  if (!saccept) return;
  if (b < p.C) {
    if (tid < 9) s.R[9 * b + tid] = s.Rn[9 * b + tid];
    if (tid < 3) s.t[3 * b + tid] = s.tn[3 * b + tid];
  } else {
    const int q = (b - p.C) * kThreads + tid;
    if (q < p.P)
      for (int i = 0; i < 3; ++i) s.X[3 * q + i] = s.Xn[3 * q + i];
  }
}

// Each point's observations as slots and cameras, and their count, so
// that the point loops know their trip count and issue their loads ahead
// (one pass per solve, after k_init has set slot_of).
__global__ void k_index(Problem p, State s) {
  const int q = blockIdx.x * kThreads + threadIdx.x;
  if (q >= p.P) return;
  int n = 0;
  for (int j = 0; j < p.PW; ++j) {
    const long long i = (long long)q * p.PW + j;
    const long long o = p.pt_rows[i];
    if (o >= p.O) break;
    s.pt_slot[i] = s.slot_of[o];
    s.pt_cam[i] = p.obs_cam[o];
    ++n;
  }
  s.pt_n[q] = n;
}

// chi2 and the prune rule (chi2 <= delta2, positive depth): the next
// stage's active set, or the outputs.
__global__ void k_classify(Problem p, State s, int final_) {
  const int o = blockIdx.x * kThreads + threadIdx.x;
  if (o >= p.O) return;
  const Eval v = evaluate_at(p, o, s.R, s.t, s.X);
  const bool keep = p.valid[o] && v.chi2 <= delta2(p, o) && v.z > 0.f;
  if (final_) {
    s.inlier[o] = keep ? 1 : 0;
    s.chi2[o] = v.chi2;
  } else {
    s.act[o] = keep ? 1.f : 0.f;
  }
}

// ---------------------------------------------------------------------------
// host side

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// The scratch layout; with base == nullptr only the size (in floats).
long long carve(State* s, float* base, int C, int P, int O, int NCH, int PW,
               int max_iters) {
  const int NB = C + blocks(P), NBO = blocks(O);
  long long off = 0;
  auto take = [&](long long n) {
    float* ptr = base ? base + off : nullptr;
    off += round4(n);
    return ptr;
  };
  State t{};
  t.Rn = take(9LL * C);
  t.tn = take(3LL * C);
  t.Xn = take(3LL * P);
  const long long NS = (long long)NCH * kChunk;
  t.lin = take(kLin * NS);
  t.slot_of = reinterpret_cast<int*>(take(O));
  t.slot_pt = reinterpret_cast<int*>(take(NS));
  t.pt_slot = reinterpret_cast<int*>(take((long long)P * PW));
  t.pt_cam = reinterpret_cast<int*>(take((long long)P * PW));
  t.pt_n = reinterpret_cast<int*>(take(P));
  t.Mc = take(36LL * C);
  t.dc = take(6LL * C);
  t.Mp = take(9LL * P);
  t.dp = take(3LL * P);
  t.xc = take(6LL * C);
  t.rc = take(6LL * C);
  t.zc = take(6LL * C);
  t.Apc = take(6LL * C);
  t.pc[0] = take(6LL * C);
  t.pc[1] = take(6LL * C);
  t.xp = take(3LL * P);
  t.rp = take(3LL * P);
  t.zp = take(3LL * P);
  t.App = take(3LL * P);
  t.pp[0] = take(3LL * P);
  t.pp[1] = take(3LL * P);
  t.pap = take(NB);
  t.rz[0] = take(NB);
  t.rz[1] = take(NB);
  t.fin = take(NB);
  t.cost = take(NBO);
  t.lam = take(max_iters + 1);
  t.cost0 = take(max_iters + 1);
  t.act = take(O);
  t.NB = NB;
  t.NS = NS;
  t.NBO = NBO;
  if (s) *s = t;
  return off;
}

}  // namespace

// Floats of scratch a solve needs (host only).
extern "C" long long local_ba_scratch_floats(int C, int P, int O, int NCH,
                                             int PW, int max_iters) {
  return carve(nullptr, nullptr, C, P, O, NCH, PW, max_iters);
}

// The whole two-stage solve: 2 + 85 per LM iteration (with 40 CG steps)
// launches per stage, 4 besides. Writes the launch count to *n_launches;
// returns the first launch error (0 if none).
extern "C" int local_ba(
    const float* R, const float* t, const unsigned char* fixed,
    const unsigned char* cam_valid, const float* X,
    const unsigned char* p_valid, const int* obs_cam, const int* obs_pt,
    const float* uv, const float* ur, const unsigned char* stereo,
    const unsigned char* valid, const float* isig, const long long* cam_rows,
    const long long* cam_chunks, const long long* pt_rows, float* R_out,
    float* t_out, float* X_out, unsigned char* inlier, float* chi2,
    float* scratch, int C, int P, int O, int NCH, int NW, int PW, int iters1,
    int iters2, int cg_iters, int huber, float fx, float fy, float cx,
    float cy, float bf, int* n_launches, void* stream_) {
  *n_launches = 0;
  if (C < 1 || P < 1 || O < 1 || NCH < 1 || NW < 1 || PW < 1 || iters1 < 0 ||
      iters2 < 0 || cg_iters < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t stream = (cudaStream_t)stream_;
  const Problem p{R, t, fixed, cam_valid, X, p_valid, obs_cam, obs_pt, uv,
                  ur, stereo, valid, isig, cam_rows, cam_chunks, pt_rows,
                  C, P, O, NCH, NW, PW, fx, fy, cx, cy, bf, huber};
  State s;
  carve(&s, scratch, C, P, O, NCH, PW, std::max(iters1, iters2));
  s.R = R_out;
  s.t = t_out;
  s.X = X_out;
  s.inlier = inlier;
  s.chi2 = chi2;
  const int nb = s.NB, nbo = s.NBO;
  int launched = 0;
  // each launch is checked at once; the first error ends the sequence
  auto ok = [&]() {
    ++launched;
    return cudaGetLastError() == cudaSuccess;
  };
  auto run = [&]() -> bool {
    const long long n =
        std::max(std::max(std::max(9LL * C, 3LL * P), (long long)O), s.NS);
    k_init<<<std::min(blocks(n), 1024), kThreads, 0, stream>>>(p, s);
    if (!ok()) return false;
    k_index<<<blocks(P), kThreads, 0, stream>>>(p, s);
    if (!ok()) return false;
    for (int stage = 0; stage < 2; ++stage) {
      const int iters = stage == 0 ? iters1 : iters2;
      if (iters > 0) {
        k_cost<<<nbo, kThreads, 0, stream>>>(p, s, 0);
        if (!ok()) return false;
        k_stage_init<<<1, kThreads, 0, stream>>>(s);
        if (!ok()) return false;
      }
      for (int it = 0; it < iters; ++it) {
        k_linearize<<<blocks(s.NS), kThreads, 0, stream>>>(p, s);
        if (!ok()) return false;
        k_normal<<<nb, kThreads, 0, stream>>>(p, s, it);
        if (!ok()) return false;
        for (int step = 0; step < cg_iters; ++step) {
          k_hv<<<nb, kHvThreads, 0, stream>>>(p, s, step);
          if (!ok()) return false;
          k_step<<<nb, kThreads, 0, stream>>>(p, s, step);
          if (!ok()) return false;
        }
        k_update<<<nb, kThreads, 0, stream>>>(p, s);
        if (!ok()) return false;
        k_cost<<<nbo, kThreads, 0, stream>>>(p, s, 1);
        if (!ok()) return false;
        k_accept<<<nb, kThreads, 0, stream>>>(p, s, it);
        if (!ok()) return false;
      }
      k_classify<<<nbo, kThreads, 0, stream>>>(p, s, stage == 1);
      if (!ok()) return false;
    }
    return true;
  };
  const bool done = run();
  *n_launches = launched;
  // the failed launch's error was consumed by ok(); report it again
  return done ? 0 : (int)cudaErrorLaunchFailure;
}
