// Bundle adjustment (robust LM + block-Jacobi PCG over cameras and points)
// as one persistent kernel per solve.
//
// Replaces xfeatslam_tpu/optim/local_ba.py bundle_adjust (:102-284), which
// is XLA code, not Pallas: two fori_loops (LM iterations, CG steps,
// :212-258) of gathers and segment sums in one jitted program. Its
// PyTorch counterpart (optim/local_ba.bundle_adjust_plain) replays that
// arithmetic as ~80 small ATen kernels per CG step, ~16,400 per round of 5
// LM iterations; this file does a whole solve in one launch.
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
// microsecond. In practice the chain of dependent phases: 2 per CG step,
// 85 per LM iteration with 40 CG steps, each a few L2 round trips long
// and ending in a grid barrier that waits for every entity's partial sums.
//
// Design: one cooperative launch per solve. The grid's CTAs (all
// resident: the occupancy's CTAs per SM times the SMs, or fewer when the
// problem has fewer blocks of work; 256 threads and up to 255 registers a
// thread) stay on their SMs for the whole solve and walk the phases below,
// separated by grid barriers (cg::this_grid().sync(), which also orders
// the phases' memory). The host issues one launch and reads nothing; lam,
// the carried cost and the accept decision live in device memory; the
// stage and CG counts are arguments. So a CUDA graph captures the solve as
// one node.
//   init: the state starts at the problem's poses and points; a camera's
//     observations fill consecutive "slots" (the rows of its SegmentPlan
//     chunks), and each point's observations and cameras are listed.
//   Once per LM iteration: linearize (Jc, Jp, the row weights and e per
//     observation, written twice: as 36 arrays over the slots, so a
//     camera's rows are read by consecutive threads at consecutive
//     addresses, and as one 144-byte row per observation, which a point's
//     thread reads whole); normal (g and the block diagonals, the damped
//     inverses, the start of PCG).
//   One CG step is two phases over the "entity blocks" (one per camera,
//     then one per 256 points):
//     hv: p = z + beta p_old for the block's own entities (beta from the
//       previous step's rz partials, which every warp sums in one fixed
//       order), written to the other of two p buffers; the matrix-free
//       (H + lam D) p, a camera block's threads over its observations in
//       plan order, a point block's thread over its point's observations
//       in order; each side recomputes the other side's p from z and
//       p_old (a CTA with point blocks stages every camera's p in shared
//       memory); pAp partials.
//     step: alpha from the partials, x += alpha p, r -= alpha Ap,
//       z = M^-1 r, rz partials (ping-pong by step parity).
//   Then the trial update, its cost and the accept (lam and the carried
//     cost one slot on).
// When every CTA owns one block (the local-BA bucket), the CG steps read
// the block's linearization from shared memory, where phase_normal left it
// once per LM iteration, and each phase issues the loads that do not wait
// for the previous phase's sums (the block's own vectors, a camera's
// points' z and p_old) before it reads them.
// Fixed ownership and order: an entity block's arithmetic does not depend
// on which CTA runs it (each CTA walks the blocks blockIdx.x, + gridDim.x,
// ...), every partial goes to the block's own slot, and every sum has one
// fixed order: a thread's terms in plan order, then a pairwise tree over
// 256 values; the partials of all blocks as 256 strided sums and the same
// tree. These are the orders of the kernel sequence this solve replaced,
// which it matches bit for bit. No atomics on floats: two solves, and a
// replay and an eager call, give the same bits, whatever the grid.
// Launched on the caller's stream; all memory comes from the caller.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

#include <algorithm>
#include <climits>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;  // a block's entities, the reduction's width
constexpr int kPtBlock = kThreads;  // points of an entity block
constexpr unsigned kFull = 0xffffffffu;
// the persistent CTA: a thread per entity of a block (255 registers a
// thread, one CTA an SM)
constexpr int kBlock = kThreads;
// hv stages every camera's p (times its free flag) in shared memory for
// the point blocks when there are at most this many cameras
constexpr int kStagedCams = 256;
// Resident (every CTA owns one entity block for the whole solve),
// phase_normal keeps the block's rows of the linearization in shared
// memory for the CG steps: a camera block's first kCamCache slots (their
// points too), a point block's first kPtCache observations of each point
// (their cameras too); the rows without e, which the steps do not read.
constexpr int kCamCache = 1024;
constexpr int kPtCache = 6;
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
  float* lin_obs;       // (O, kLin): the same rows by observation
  int* slot_pt;         // (NS,) a slot's point, -1 for an empty slot
  int* pt_obs;          // (P, PW) a point's observations
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

constexpr int kRowKept = kE;
// entries of the cache, in either layout
constexpr int kEntries = kPtBlock * kPtCache > kCamCache ? kPtBlock * kPtCache
                                                        : kCamCache;
// floats of the cache (dynamic shared memory): an index and kRowKept
// floats per entry
constexpr int kCacheFloats = (1 + kRowKept) * kEntries;

// The shared-memory cache: entry e (a camera block's slot, or point t's
// observation j at j * kPtBlock + t, so that a warp's threads read
// consecutive words) holds an index (a slot's point, or an observation's
// camera) and row k at row()[k * kEntries + e].
struct Cache {
  float* dyn;
  int* n_slots;  // a camera block's slots, all of them
  __device__ __forceinline__ int* idx() const {
    return reinterpret_cast<int*>(dyn);
  }
  __device__ __forceinline__ float* row() const { return dyn + kEntries; }
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

// Observation o's row of lin_obs (kLin contiguous floats, 16-byte
// aligned), read as float4s: the point side reads each observation's row
// whole, so no load fetches a sector it does not use.
__device__ __forceinline__ void load_obs_row(const float* lin_obs, int o,
                                             float (&L)[kLin]) {
  const float4* a = reinterpret_cast<const float4*>(lin_obs + (long long)o * kLin);
#pragma unroll
  for (int k = 0; k < kLin / 4; ++k) {
    const float4 v = a[k];
    L[4 * k] = v.x;
    L[4 * k + 1] = v.y;
    L[4 * k + 2] = v.z;
    L[4 * k + 3] = v.w;
  }
}

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

// The sums of red[k * kThreads + t] over t < kThreads (written and synced
// before the call) in one fixed pairwise tree: pairs t, t + s for s = 128,
// 64, ..., 1. Warp 0 adds them: lane l holds slots l, l + 32, ..., l + 224
// and adds the first three levels among them, the last five by shuffles.
// The totals are lane 0's out; red may be written again after the
// caller's next barrier.
template <int K>
__device__ __forceinline__ void cta_tree(const float* red, float (&out)[K]) {
  if (threadIdx.x >= 32) return;
  const int l = threadIdx.x;
#pragma unroll
  for (int k = 0; k < K; ++k) {
    float x[8];
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = red[k * kThreads + l + 32 * u];
#pragma unroll
    for (int u = 0; u < 4; ++u) x[u] = x[u] + x[u + 4];  // s = 128
    x[0] = x[0] + x[2];                                  // s = 64
    x[1] = x[1] + x[3];
    x[0] = x[0] + x[1];                                  // s = 32
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) x[0] += __shfl_down_sync(kFull, x[0], o);
    out[k] = x[0];
  }
}

// cta_tree of one value per thread of the first kThreads (a larger CTA's
// other threads only take part in the barrier): the totals are thread 0's.
template <int K>
__device__ __forceinline__ void cta_sum(const float (&v)[K], float* red,
                                        float (&out)[K]) {
  if (threadIdx.x < kThreads)
#pragma unroll
    for (int k = 0; k < K; ++k) red[k * kThreads + threadIdx.x] = v[k];
  __syncthreads();
  cta_tree<K>(red, out);
}

// The sum of a[0..n) in the order of the tree above (slot t the sum of
// a[t], a[t + kThreads], ... in order), computed by every warp on its own:
// every lane of every CTA gets the same bits, with no barrier.
__device__ __forceinline__ float warp_sum(const float* a, int n) {
  const int l = threadIdx.x & 31;
  float x[8];
  if (n <= kThreads) {  // a value a slot at most: the loads at once
#pragma unroll
    for (int u = 0; u < 8; ++u) x[u] = l + 32 * u < n ? a[l + 32 * u] : 0.f;
  } else {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      float t = 0.f;
      for (int i = l + 32 * u; i < n; i += kThreads) t += a[i];
      x[u] = t;
    }
  }
#pragma unroll
  for (int u = 0; u < 4; ++u) x[u] = x[u] + x[u + 4];
  x[0] = x[0] + x[2];
  x[1] = x[1] + x[3];
  x[0] = x[0] + x[1];
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x[0] += __shfl_down_sync(kFull, x[0], o);
  return __shfl_sync(kFull, x[0], 0);
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
// phases of the solve. Each is run by every CTA of the grid: the grid-stride
// ones over their elements, the others over their blocks b = blockIdx.x,
// blockIdx.x + gridDim.x, ... (the same count of trips for every thread of
// a CTA, so the CTA's barriers inside a block's work are reached by all).

__device__ __forceinline__ long long grid_first() {
  return (long long)blockIdx.x * kBlock + threadIdx.x;
}

__device__ __forceinline__ long long grid_stride() {
  return (long long)gridDim.x * kBlock;
}

// The state starts at the problem's poses and points; stage 1's active
// set is the valid observations; each slot's point; each point's
// observations and their cameras, and
// their count, so that the point loops know their trip count and issue
// their loads ahead.
__device__ void phase_init(const Problem& p, const State& s) {
  long long n = max(max(p.C * 9, p.P * 3), p.O);
  if (s.NS > n) n = s.NS;
  for (long long i = grid_first(); i < n; i += grid_stride()) {
    if (i < p.C * 9) s.R[i] = p.R[i];
    if (i < p.C * 3) s.t[i] = p.t[i];
    if (i < p.P * 3) s.X[i] = p.X[i];
    if (i < p.O) s.act[i] = p.valid[i] ? 1.f : 0.f;
    if (i < s.NS) {
      const long long o = p.cam_rows[i];
      s.slot_pt[i] = o < p.O ? p.obs_pt[o] : -1;
    }
  }
  for (long long qq = grid_first(); qq < p.P; qq += grid_stride()) {
    const int q = (int)qq;
    int n = 0;
    for (int j = 0; j < p.PW; ++j) {
      const long long i = (long long)q * p.PW + j;
      const long long o = p.pt_rows[i];
      if (o >= p.O) break;
      s.pt_obs[i] = (int)o;
      s.pt_cam[i] = p.obs_cam[o];
      ++n;
    }
    s.pt_n[q] = n;
  }
}

// Partials of the robust cost over the active observations, at the
// current solution or at the trial: one per block of kThreads
// observations.
__device__ void phase_cost(const Problem& p, const State& s, int trial,
                           float* red) {
  for (int b = blockIdx.x; b < s.NBO; b += gridDim.x) {
    const int o = b * kThreads + threadIdx.x;
    float c = 0.f;
    if (threadIdx.x < kThreads && o < p.O) {
      const Eval v = trial ? evaluate_at(p, o, s.Rn, s.tn, s.Xn)
                           : evaluate_at(p, o, s.R, s.t, s.X);
      c = s.act[o] != 0.f ? robust_cost(p, v.chi2, delta2(p, o)) : 0.f;
    }
    const float vals[1] = {c};
    float tot[1];
    cta_sum<1>(vals, red, tot);
    if (threadIdx.x == 0) s.cost[b] = tot[0];
    __syncthreads();
  }
}

// A stage's start: the carried cost and lam = 1e-4 (one CTA, after the
// stage's first cost phase).
__device__ void stage_init(const State& s) {
  const float c = warp_sum(s.cost, s.NBO);
  if (threadIdx.x == 0) {
    s.cost0[0] = c;
    s.lam[0] = 1e-4f;
  }
}

// The linearization at the current solution: Jc, Jp (the plain version's
// signs), the row weights w (1, 1, stereo) with w = huber(chi2) s active,
// and e. A thread per slot.
__device__ void phase_linearize(const Problem& p, const State& s) {
  for (long long slot = grid_first(); slot < s.NS; slot += grid_stride()) {
    const long long ol = p.cam_rows[slot];
    if (ol >= p.O) continue;
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
    float L[kLin];
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      // Jc = -J [I | -hat(Xc)], Jp = -J R
      L[6 * r + 0] = -J[r][0];
      L[6 * r + 1] = -J[r][1];
      L[6 * r + 2] = -J[r][2];
      L[6 * r + 3] = J[r][1] * v.z - J[r][2] * v.y;
      L[6 * r + 4] = J[r][2] * v.x - J[r][0] * v.z;
      L[6 * r + 5] = J[r][0] * v.y - J[r][1] * v.x;
#pragma unroll
      for (int k = 0; k < 3; ++k)
        L[kJp + 3 * r + k] =
            -(J[r][0] * R[k] + J[r][1] * R[3 + k] + J[r][2] * R[6 + k]);
      L[kE + r] = v.e[r];
    }
    L[kWr] = w;
    L[kWr + 1] = w;
    L[kWr + 2] = p.stereo[o] ? w : 0.f;
#pragma unroll
    for (int k = kE + 3; k < kLin; ++k) L[k] = 0.f;
    const Row row{s.lin + slot, s.NS};
#pragma unroll
    for (int k = 0; k < kLin; ++k) row[k] = L[k];
    float4* a = reinterpret_cast<float4*>(s.lin_obs + (long long)o * kLin);
#pragma unroll
    for (int k = 0; k < kLin / 4; ++k)
      a[k] = make_float4(L[4 * k], L[4 * k + 1], L[4 * k + 2], L[4 * k + 3]);
  }
}

// g and the block diagonals per camera and per point, the damped
// inverses, and the start of PCG: x = 0, r = -g, z = M^-1 r, rz partials
// (parity 0). Entity blocks.
__device__ void phase_normal(const Problem& p, const State& s, int it,
                             float* red, const Cache& cache) {
  const int tid = threadIdx.x;
  const float lam = s.lam[it];
  const bool resident = gridDim.x >= s.NB;
  for (int b = blockIdx.x; b < s.NB; b += gridDim.x) {
    if (b < p.C) {
      const int c = b;
      float acc[27];
      for (int k = 0; k < 27; ++k) acc[k] = 0.f;
      if (resident && tid == 0) *cache.n_slots = 0;
      __syncthreads();
      int n_slots = 0;
      for (int j = tid; tid < kThreads; j += kThreads) {  // kThreads walk
        const long long slot = cam_slot(p, c, j);
        if (slot < 0) break;
        ++n_slots;
        const int q = s.slot_pt[slot];
        const bool keep = resident && j < kCamCache;
        if (keep) cache.idx()[j] = q;
        if (q < 0) continue;
        const Row row{s.lin + slot, s.NS};
        if (keep)
          for (int k = 0; k < kRowKept; ++k)
            cache.row()[k * kEntries + j] = row[k];
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
      if (resident) atomicAdd(cache.n_slots, n_slots);  // an exact count
      float tot[27];
      cta_sum<27>(acc, red, tot);
      if (tid == 0) {
        const float f = free_cam(p, c);
        float H[6][6], g[6];
        int k = 6;
        for (int i = 0; i < 6; ++i) {
          g[i] = tot[i] * f;
          for (int m = i; m < 6; ++m) {
            H[i][m] = H[m][i] = tot[k++];
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
      const int q = (b - p.C) * kPtBlock + tid;
      float rz = 0.f;
      if (tid < kPtBlock && q < p.P) {
        float acc[9] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
        const long long base = (long long)q * p.PW;
        const int n = s.pt_n[q];
        for (int j = 0; j < n; ++j) {
          float L[kLin];
          load_obs_row(s.lin_obs, s.pt_obs[base + j], L);
          if (resident && j < kPtCache) {
            const int e = j * kPtBlock + tid;
            cache.idx()[e] = s.pt_cam[base + j];
            for (int k = 0; k < kRowKept; ++k)
              cache.row()[k * kEntries + e] = L[k];
          }
#pragma unroll
          for (int r = 0; r < 3; ++r) {
            const float wr = L[kWr + r], e = L[kE + r];
            int k = 3;
#pragma unroll
            for (int i = 0; i < 3; ++i) {
              const float jw = L[kJp + 3 * r + i] * wr;
              acc[i] += jw * e;
#pragma unroll
              for (int m = i; m < 3; ++m)
                acc[k++] += jw * L[kJp + 3 * r + m];
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
      float tot[1];
      cta_sum<1>(v, red, tot);
      if (tid == 0) s.rz[0][b] = tot[0];
    }
    __syncthreads();  // red is the next block's
  }
}

// p of CG step `step` at entry i of z / p_old: z at step 0, else
// z + beta p_old (one fused multiply-add wherever it is evaluated, so the
// owner's stored value and a reader's recomputed one are the same bits).
__device__ __forceinline__ float p_at(const float* z, const float* pold,
                                      int step, float beta, long long i) {
  return step == 0 ? z[i] : fmaf(beta, pold[i], z[i]);
}

// One observation's terms of a camera block's (H + lam D) p: r v (3) from
// its rows (Jc, Jp, the row weights) at the camera's masked p and the
// point's, added to h in the order of the plain walk (row by row).
template <typename RowT>
__device__ __forceinline__ void cam_terms(const RowT& row, const float vcm[6],
                                          const float vp[3], float h[6]) {
  for (int r = 0; r < 3; ++r) {
    float a = 0.f;
    for (int i = 0; i < 6; ++i) a += row[6 * r + i] * vcm[i];
    float d = 0.f;
    for (int i = 0; i < 3; ++i) d += row[kJp + 3 * r + i] * vp[i];
    const float rv = (a + d) * row[kWr + r];
    for (int i = 0; i < 6; ++i) h[i] += row[6 * r + i] * rv;
  }
}

// A row of the shared-memory cache: entry e of kRowKept arrays of
// kEntries.
struct CachedRow {
  const float* base;
  __device__ __forceinline__ float operator[](int k) const {
    return base[k * kEntries];
  }
};

// (H + lam D) p over the observations, with p = z + beta p_old written to
// this step's p buffer for the block's own entities; pAp partials. A
// camera block's threads walk its observations; a point block's threads
// each take one point's observations in order. Resident, the rows come
// from the shared-memory cache that phase_normal filled, and the loads
// that do not need beta (the block's own z, p_old and damping, and a
// camera's points' z and p_old) are issued before it.
__device__ void phase_hv(const Problem& p, const State& s, int step,
                         float* red, float* cam_p, const Cache& cache) {
  const int tid = threadIdx.x;
  const int cur = step & 1, prev = cur ^ 1;
  const float* pc_old = s.pc[prev];
  const float* pp_old = s.pp[prev];
  const bool resident = gridDim.x >= s.NB;
  const int b0 = blockIdx.x;
  constexpr int kPer = kCamCache / kThreads;  // cached slots per thread
  float z0[6], o0[6], d0[6];  // the resident block's own entity
  int qs[kPer];               // a camera thread's cached slots' points
  float zq[kPer][3], pq[kPer][3], fq[kPer];
  int n0 = 0;                 // a point's observation count
  float f0 = 0.f;             // a camera's free flag, a point's valid flag
  const int pt0 = (b0 - p.C) * kPtBlock + tid;
  if (resident && b0 < p.C) {
    for (int i = 0; i < 6; ++i) {
      z0[i] = s.zc[6 * b0 + i];
      o0[i] = pc_old[6 * b0 + i];
      d0[i] = s.dc[6 * b0 + i];
    }
    f0 = free_cam(p, b0);
    const int ns = min(*cache.n_slots, kCamCache);
#pragma unroll
    for (int k = 0; k < kPer; ++k) {
      const int j = tid + k * kThreads;
      qs[k] = j < ns ? cache.idx()[j] : -1;
      for (int i = 0; i < 3; ++i) {
        zq[k][i] = qs[k] >= 0 ? s.zp[3 * qs[k] + i] : 0.f;
        pq[k][i] = qs[k] >= 0 ? pp_old[3 * qs[k] + i] : 0.f;
      }
      fq[k] = qs[k] >= 0 ? valid_pt(p, qs[k]) : 0.f;
    }
  } else if (resident && b0 < s.NB && pt0 < p.P) {
    n0 = s.pt_n[pt0];
    for (int i = 0; i < 3; ++i) {
      z0[i] = s.zp[3 * pt0 + i];
      o0[i] = pp_old[3 * pt0 + i];
      d0[i] = s.dp[3 * pt0 + i];
    }
    f0 = valid_pt(p, pt0);
  }
  // a CTA with point blocks stages every camera's p (times its free flag),
  // the same bits as its owner's, so that its observations read them from
  // shared memory; z, p_old and the flag are loaded before beta
  bool points = false;
  for (int b = blockIdx.x; b < s.NB; b += gridDim.x) points = points || b >= p.C;
  const bool staged = points && p.C <= kStagedCams;
  constexpr int kStagedPer = 6 * kStagedCams / kBlock;
  float sz[kStagedPer], so[kStagedPer], sf[kStagedPer];
  if (staged) {
#pragma unroll
    for (int k = 0; k < kStagedPer; ++k) {
      const int e = tid + k * kBlock;
      const bool in = e < 6 * p.C;
      sz[k] = in ? s.zc[e] : 0.f;
      so[k] = in ? pc_old[e] : 0.f;
      sf[k] = in ? free_cam(p, e / 6) : 0.f;
    }
  }
  const float beta = step > 0 ? warp_sum(s.rz[cur], s.NB) /
                                    guard(warp_sum(s.rz[prev], s.NB))
                              : 0.f;
  // p from z and p_old as p_at computes it
  auto p_of = [&](float z, float pold) {
    return step == 0 ? z : fmaf(beta, pold, z);
  };
  if (staged) {
#pragma unroll
    for (int k = 0; k < kStagedPer; ++k) {
      const int e = tid + k * kBlock;
      // entry i of camera c at i * C + c: a warp's cameras on distinct
      // banks
      if (e < 6 * p.C)
        cam_p[(e % 6) * p.C + e / 6] = p_of(sz[k], so[k]) * sf[k];
    }
    __syncthreads();
  }
  for (int b = blockIdx.x; b < s.NB; b += gridDim.x) {
    if (b < p.C) {
      const int c = b;
      const float f = resident ? f0 : free_cam(p, c);
      float vc[6], vcm[6];
      for (int i = 0; i < 6; ++i) {
        vc[i] = resident ? p_of(z0[i], o0[i])
                         : p_at(s.zc, pc_old, step, beta, 6 * c + i);
        vcm[i] = vc[i] * f;
      }
      float h[6] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      // the walk of kThreads threads: j = tid, tid + kThreads, ...
      int j = tid;
      if (resident) {
#pragma unroll
        for (int k = 0; k < kPer; ++k) {
          if (qs[k] < 0) continue;
          float vp[3];
          for (int i = 0; i < 3; ++i) vp[i] = p_of(zq[k][i], pq[k][i]) * fq[k];
          cam_terms(CachedRow{cache.row() + tid + k * kThreads}, vcm, vp, h);
        }
        j = tid + kCamCache;  // past the cache, from L2
      }
      const int ns = resident ? *cache.n_slots : INT_MAX;
      for (; j < ns; j += kThreads) {
        const long long slot = cam_slot(p, c, j);
        if (slot < 0) break;
        const int q = s.slot_pt[slot];
        if (q < 0) continue;
        const float fqq = valid_pt(p, q);
        float vp[3];
        for (int i = 0; i < 3; ++i)
          vp[i] = p_at(s.zp, pp_old, step, beta, 3 * q + i) * fqq;
        cam_terms(Row{s.lin + slot, s.NS}, vcm, vp, h);
      }
      float tot[6];
      cta_sum<6>(h, red, tot);
      if (tid == 0) {
        float pap = 0.f;
        for (int i = 0; i < 6; ++i) {
          const float dc = resident ? d0[i] : s.dc[6 * c + i];
          const float ap = (tot[i] + dc * vc[i]) * f;
          s.Apc[6 * c + i] = ap;
          s.pc[cur][6 * c + i] = vc[i];
          pap += vc[i] * ap;
        }
        s.pap[b] = pap;
      }
    } else {
      const int q = (b - p.C) * kPtBlock + tid;
      float vp[3] = {0.f, 0.f, 0.f}, vpm[3] = {0.f, 0.f, 0.f}, fqq = 0.f,
            dp[3] = {0.f, 0.f, 0.f};
      const long long base = (long long)q * p.PW;
      int n = 0;
      if (q < p.P) {
        n = resident ? n0 : s.pt_n[q];
        fqq = resident ? f0 : valid_pt(p, q);
        for (int i = 0; i < 3; ++i) {
          vp[i] = resident ? p_of(z0[i], o0[i])
                           : p_at(s.zp, pp_old, step, beta, 3 * q + i);
          vpm[i] = vp[i] * fqq;
          dp[i] = resident ? d0[i] : s.dp[3 * q + i];
        }
      }
      // the point's observations in order: Jp^T r v
      float h[3] = {0.f, 0.f, 0.f};
      for (int j = 0; j < n; ++j) {
        const bool cached = resident && j < kPtCache;
        const int e = j * kPtBlock + tid;
        const int c = cached ? cache.idx()[e] : s.pt_cam[base + j];
        float vc[6];
        if (staged) {
          for (int i = 0; i < 6; ++i) vc[i] = cam_p[i * p.C + c];
        } else {
          const float fc = free_cam(p, c);
          for (int i = 0; i < 6; ++i)
            vc[i] = p_at(s.zc, pc_old, step, beta, 6 * c + i) * fc;
        }
        float L[kLin];
        if (cached) {
          const CachedRow row{cache.row() + e};
#pragma unroll
          for (int k = 0; k < kRowKept; ++k) L[k] = row[k];
        } else {
          load_obs_row(s.lin_obs, s.pt_obs[base + j], L);
        }
        float rv[3];
#pragma unroll
        for (int r = 0; r < 3; ++r) {
          float a = 0.f;
          for (int i = 0; i < 6; ++i) a += L[6 * r + i] * vc[i];
          float d = 0.f;
          for (int i = 0; i < 3; ++i) d += L[kJp + 3 * r + i] * vpm[i];
          rv[r] = (a + d) * L[kWr + r];
        }
        for (int r = 0; r < 3; ++r)
          for (int i = 0; i < 3; ++i) h[i] += L[kJp + 3 * r + i] * rv[r];
      }
      float pap[1] = {0.f};
      if (q < p.P) {
        for (int i = 0; i < 3; ++i) {
          const float ap = (h[i] + dp[i] * vp[i]) * fqq;
          s.App[3 * q + i] = ap;
          s.pp[cur][3 * q + i] = vp[i];
          pap[0] += vp[i] * ap;
        }
      }
      float tot[1];
      cta_sum<1>(pap, red, tot);
      if (tid == 0) s.pap[b] = tot[0];
    }
    __syncthreads();  // red is the next block's
  }
}

// alpha = rz / pAp; x += alpha p, r -= alpha Ap, z = M^-1 r; the next
// step's rz partials.
__device__ void phase_step(const Problem& p, const State& s, int step,
                           float* red) {
  const int tid = threadIdx.x;
  const int cur = step & 1, next = cur ^ 1;
  // the first block's loads, which do not need alpha, issued before it: x,
  // p, r, Ap, the rows of M^-1 and the free or valid flag of a camera's
  // entry (lanes 0-5) or of a point (a thread each)
  const int b0 = blockIdx.x;
  float xs[3], ps[3], rs[3], as[3], Ms[9], f0 = 0.f;
  if (b0 < p.C) {
    if (tid < 6) {
      const int k = 6 * b0 + tid;
      xs[0] = s.xc[k];
      ps[0] = s.pc[cur][k];
      rs[0] = s.rc[k];
      as[0] = s.Apc[k];
      for (int m = 0; m < 6; ++m) Ms[m] = s.Mc[36 * b0 + 6 * tid + m];
      f0 = free_cam(p, b0);
    }
  } else if (b0 < s.NB) {
    const int q = (b0 - p.C) * kPtBlock + tid;
    if (tid < kPtBlock && q < p.P) {
      for (int i = 0; i < 3; ++i) {
        const int k = 3 * q + i;
        xs[i] = s.xp[k];
        ps[i] = s.pp[cur][k];
        rs[i] = s.rp[k];
        as[i] = s.App[k];
      }
      for (int i = 0; i < 9; ++i) Ms[i] = s.Mp[9 * q + i];
      f0 = valid_pt(p, q);
    }
  }
  const float alpha = warp_sum(s.rz[cur], s.NB) / guard(warp_sum(s.pap,
                                                                 s.NB));
  for (int b = blockIdx.x; b < s.NB; b += gridDim.x) {
    const bool ahead = b == b0;
    if (b < p.C) {
      if (tid < 6) {  // lane i: entry i of the camera's 6
        constexpr unsigned kSix = 0x3fu;
        const int c = b, k = 6 * c + tid;
        if (!ahead) {
          xs[0] = s.xc[k];
          ps[0] = s.pc[cur][k];
          rs[0] = s.rc[k];
          as[0] = s.Apc[k];
          for (int m = 0; m < 6; ++m) Ms[m] = s.Mc[36 * c + 6 * tid + m];
          f0 = free_cam(p, c);
        }
        s.xc[k] = xs[0] + alpha * ps[0];
        const float r = rs[0] - alpha * as[0];
        s.rc[k] = r;
        float z = 0.f;
#pragma unroll
        for (int m = 0; m < 6; ++m) z += Ms[m] * __shfl_sync(kSix, r, m);
        z = z * f0;
        s.zc[k] = z;
        float acc = 0.f;  // r.z in entry order, as one thread would add it
#pragma unroll
        for (int i = 0; i < 6; ++i)
          acc += __shfl_sync(kSix, r, i) * __shfl_sync(kSix, z, i);
        if (tid == 0) s.rz[next][b] = acc;
      }
    } else {
      const int q = (b - p.C) * kPtBlock + tid;
      float acc = 0.f;
      if (tid < kPtBlock && q < p.P) {
        if (!ahead) {
          for (int i = 0; i < 3; ++i) {
            const int k = 3 * q + i;
            xs[i] = s.xp[k];
            ps[i] = s.pp[cur][k];
            rs[i] = s.rp[k];
            as[i] = s.App[k];
          }
          for (int i = 0; i < 9; ++i) Ms[i] = s.Mp[9 * q + i];
          f0 = valid_pt(p, q);
        }
        float r[3];
        for (int i = 0; i < 3; ++i) {
          const int k = 3 * q + i;
          s.xp[k] = xs[i] + alpha * ps[i];
          r[i] = rs[i] - alpha * as[i];
          s.rp[k] = r[i];
        }
        for (int i = 0; i < 3; ++i) {
          float z = 0.f;
          for (int m = 0; m < 3; ++m) z += Ms[3 * i + m] * r[m];
          z = z * f0;
          s.zp[3 * q + i] = z;
          acc += r[i] * z;
        }
      }
      const float v[1] = {acc};
      float tot[1];
      cta_sum<1>(v, red, tot);
      if (tid == 0) s.rz[next][b] = tot[0];
      __syncthreads();  // red is the next block's
    }
  }
}

// The trial: exp(xc) T on free cameras (ops/lie.se3_exp, then compose),
// X + xp on valid points; whether every step entry of the block is finite.
__device__ void phase_update(const Problem& p, const State& s) {
  const int tid = threadIdx.x;
  for (int b = blockIdx.x; b < s.NB; b += gridDim.x) {
    if (b < p.C) {
      if (tid != 0) continue;
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
        continue;
      }
      const float px = dx[3], py = dx[4], pz = dx[5];
      const float th2 = px * px + py * py + pz * pz;
      const float th = sqrtf(th2 + 1e-16f);
      const bool small = th2 < 1e-8f;
      const float sn = sinf(th), cs = cosf(th);
      const float a = small ? 1.f - th2 / 6.f : sn / th;
      const float bb = small ? 0.5f - th2 / 24.f : (1.f - cs) / th2;
      const float cc =
          small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th);
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
                (V[3 * m] * dx[0] + V[3 * m + 1] * dx[1] +
                 V[3 * m + 2] * dx[2]);
      }
    } else {
      const int q = (b - p.C) * kPtBlock + tid;
      bool fin = true;
      if (tid < kPtBlock && q < p.P) {
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
}

// Accept the trial when its cost is lower and every step is finite; the
// next iteration's lam and carried cost (one slot on). Entity blocks.
__device__ void phase_accept(const Problem& p, const State& s, int it) {
  const int tid = threadIdx.x;
  const float cost1 = warp_sum(s.cost, s.NBO);
  bool fin = true;
  for (int i = tid & 31; i < s.NB; i += 32) fin = fin && s.fin[i] != 0.f;
  fin = __all_sync(kFull, fin);
  const float cost0 = s.cost0[it];
  const bool accept = cost1 < cost0 && fin;
  if (blockIdx.x == 0 && tid == 0) {  // entity block 0's owner
    s.cost0[it + 1] = accept ? cost1 : cost0;
    s.lam[it + 1] = accept ? s.lam[it] * 0.5f : s.lam[it] * 4.f;
  }
  if (!accept) return;
  for (int b = blockIdx.x; b < s.NB; b += gridDim.x) {
    if (b < p.C) {
      if (tid < 9) s.R[9 * b + tid] = s.Rn[9 * b + tid];
      if (tid < 3) s.t[3 * b + tid] = s.tn[3 * b + tid];
    } else {
      const int q = (b - p.C) * kPtBlock + tid;
      if (tid < kPtBlock && q < p.P)
        for (int i = 0; i < 3; ++i) s.X[3 * q + i] = s.Xn[3 * q + i];
    }
  }
}

// chi2 and the prune rule (chi2 <= delta2, positive depth): the next
// stage's active set, or the outputs.
__device__ void phase_classify(const Problem& p, const State& s, int final_) {
  for (long long oo = grid_first(); oo < p.O; oo += grid_stride()) {
    const int o = (int)oo;
    const Eval v = evaluate_at(p, o, s.R, s.t, s.X);
    const bool keep = p.valid[o] && v.chi2 <= delta2(p, o) && v.z > 0.f;
    if (final_) {
      s.inlier[o] = keep ? 1 : 0;
      s.chi2[o] = v.chi2;
    } else {
      s.act[o] = keep ? 1.f : 0.f;
    }
  }
}

// The whole two-stage solve; every CTA resident (a cooperative launch).
__global__ void __launch_bounds__(kBlock, 1)
k_solve(const Problem p, const State s, int iters1, int iters2,
        int cg_iters) {
  __shared__ float red[27 * kThreads];
  __shared__ float cam_p[6 * kStagedCams];
  __shared__ int n_slots;
  extern __shared__ float dyn[];  // kCacheFloats, when resident
  const Cache cache{dyn, &n_slots};
  cg::grid_group grid = cg::this_grid();
  phase_init(p, s);
  grid.sync();
  for (int stage = 0; stage < 2; ++stage) {
    const int iters = stage == 0 ? iters1 : iters2;
    if (iters > 0) {
      phase_cost(p, s, 0, red);
      grid.sync();
    }
    for (int it = 0; it < iters; ++it) {
      if (it == 0 && blockIdx.x == 0) stage_init(s);
      phase_linearize(p, s);
      grid.sync();
      phase_normal(p, s, it, red, cache);
      grid.sync();
      for (int step = 0; step < cg_iters; ++step) {
        phase_hv(p, s, step, red, cam_p, cache);
        grid.sync();
        phase_step(p, s, step, red);
        grid.sync();
      }
      phase_update(p, s);
      grid.sync();
      phase_cost(p, s, 1, red);
      grid.sync();
      phase_accept(p, s, it);
      grid.sync();
    }
    phase_classify(p, s, stage == 1);
    if (stage == 0) grid.sync();
  }
}

// ---------------------------------------------------------------------------
// host side

inline int blocks(long long n) { return (int)((n + kThreads - 1) / kThreads); }

inline long long round4(long long n) { return (n + 3) & ~3LL; }

// The scratch layout; with base == nullptr only the size (in floats).
long long carve(State* s, float* base, int C, int P, int O, int NCH, int PW,
               int max_iters) {
  const int NB = C + (P + kPtBlock - 1) / kPtBlock, NBO = blocks(O);
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
  t.lin_obs = take((long long)kLin * O);
  t.slot_pt = reinterpret_cast<int*>(take(NS));
  t.pt_obs = reinterpret_cast<int*>(take((long long)P * PW));
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

constexpr int kCacheBytes = kCacheFloats * (int)sizeof(float);

// The grid of a solve: every CTA resident (the occupancy's CTAs per SM
// times the SMs), and no more than the largest phase has blocks of work.
// Cached per device, with the cache's shared memory allowed the first
// time.
int solve_grid(int dev, long long work_blocks, cudaError_t* err) {
  static int resident[64] = {};
  if (dev < 0 || dev >= 64) {
    *err = cudaErrorInvalidDevice;
    return 0;
  }
  if (resident[dev] == 0) {
    int per_sm = 0, sms = 0;
    *err = cudaFuncSetAttribute(
        k_solve, cudaFuncAttributeMaxDynamicSharedMemorySize, kCacheBytes);
    if (*err != cudaSuccess) return 0;
    *err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, k_solve,
                                                         kBlock, kCacheBytes);
    if (*err != cudaSuccess) return 0;
    *err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    if (*err != cudaSuccess) return 0;
    resident[dev] = per_sm * sms;
  }
  *err = cudaSuccess;
  return (int)std::max(1LL, std::min((long long)resident[dev], work_blocks));
}

}  // namespace

// Floats of scratch a solve needs (host only).
extern "C" long long local_ba_scratch_floats(int C, int P, int O, int NCH,
                                             int PW, int max_iters) {
  return carve(nullptr, nullptr, C, P, O, NCH, PW, max_iters);
}

// The whole two-stage solve in one cooperative launch. Writes the launch
// count (1, or 0 if the launch was refused) to *n_launches; returns the
// launch's error (0 if none).
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
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  // the most blocks any phase has: the entity blocks, the observation
  // blocks, and the grid-stride phases' elements in CTAs of kBlock
  const long long elems =
      std::max(std::max(std::max(9LL * C, 3LL * P), (long long)O), s.NS);
  const long long work = std::max(std::max((long long)s.NB, (long long)s.NBO),
                                  (elems + kBlock - 1) / kBlock);
  const int grid = solve_grid(dev, work, &err);
  if (err != cudaSuccess) return (int)err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kBlock);
  cfg.dynamicSmemBytes = kCacheBytes;
  cfg.stream = (cudaStream_t)stream_;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeCooperative;
  attr[0].val.cooperative = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, k_solve, p, s, iters1, iters2, cg_iters);
  if (err == cudaSuccess) err = cudaGetLastError();
  if (err == cudaSuccess) *n_launches = 1;
  return (int)err;
}
