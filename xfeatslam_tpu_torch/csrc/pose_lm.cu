// The robust pose LM (Optimizer::PoseOptimization) in one launch.
//
// Replaces xfeatslam_tpu/optim/pose_opt.py pose_optimization (:82-193),
// which is XLA code, not Pallas: one jitted fori_loop program there. Its
// PyTorch counterpart (ops/cuda_kernels.pose_lm_plain) replays the same
// arithmetic as ~250 small ATen kernels per LM iteration, ~20,000 per
// call; this kernel does the whole call in one launch.
//
// What it computes, as the plain version does: one SE3 pose T = (R, t)
// against N unary edges (mono (u, v), stereo (u, v, uR) with
// uR = u - bf/z), chi2 = e^T e * inv_sigma2, Huber at 5.991 (mono) and
// 7.815 (stereo) times a width scale. Two schedules from (R0, t0), each of
// `rounds` rounds of `iters` Levenberg-Marquardt iterations:
//   A: width scale 1 in every round, Huber in the first two;
//   B: width scales 25, 9, 3, 1, 1, ..., Huber in every round.
// A round keeps its active edges (valid, and from round 1 on chi2 at the
// round's start <= the round's width); lam starts at 1e-3; an iteration
// solves (Hs) y = b s with Hd = H + lam diag(H) + 1e-6 I,
// s = rsqrt(diag(Hd) + 1e-12), Hs = s Hd s, dx = y s (partial pivoting),
// updates T <- exp(dx) T and accepts when the robust cost falls and dx is
// finite (lam * 0.5), else rejects (lam * 4). B wins when its Huber cost
// over the valid edges is lower and its t is finite. Outputs R, t, chi2 at
// the pick, inliers = valid & chi2 <= 5.991 / 7.815 and their count.
//
// What bounds it on an H100: neither bytes nor operations. At N = 1000 it
// reads ~30 KB and does ~10 MFLOP, microseconds of either; what takes the
// time is each schedule's chain of rounds x (iters + 1) + 1 dependent
// passes over the edges (46 at 4 x 10), each ending in a block reduction
// and a 6x6 solve that the next pass waits for.
//
// Design. Two CTAs of 512 threads in one thread-block cluster, one
// schedule each, on two SMs: the schedules run side by side, each with its
// own barriers. Each CTA stages the valid edges once into dynamic shared
// memory, compacted in index order so that they spread evenly over the
// threads, as structure of arrays (Xw, uv, ur, inv_sigma2: 28 B an edge,
// 229,376 B at the 8,192 edges it takes); thread l owns staged edges l,
// l + 512, ..., and keeps their stereo and active flags as bit masks in
// registers. A pass reads shared memory only: each thread's partial sums of the 21
// upper-triangle entries of H, the 6 of b and the robust cost, a
// reduce-scatter over the warp's lanes (31 shuffles: lane k ends with the
// warp's sum of value k), and a fixed-order sum of the 16 warps by warp 0.
// Warp 0 holds the LM state and decides: the accept test, then the
// damped, scaled 6x6 solve with partial pivoting on its lanes (lane n
// holds column n of the system, lane 6 the right-hand side; shuffles
// carry the pivot row and column), then the exp-map update, and it writes
// the next pose to shared memory. The other warps wait at one barrier a
// pass: they arrive at the reduction's barrier without waiting and wait
// at the pose's, which warp 0 arrives at once the pose is written (two
// named barriers). The pass at the trial pose gives the trial cost and
// also H and b there, which are the next iteration's normal equations
// when the step is accepted (on a reject the pose and so H and b stay),
// so an iteration is one pass. After the rounds each CTA takes its
// schedule's Huber cost over the valid edges and publishes it with its
// pose in shared memory; after a cluster barrier both read the other's
// through distributed shared memory, make the same pick, and classify
// half of the edges each. No atomics on floats (the stereo bits are OR-ed
// in), one summation order: an eager call
// and a graph replay give the same bits, as do two runs. Launched on the
// caller's stream; no allocation and no host sync.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 512;            // threads per schedule (CTA)
constexpr int kWarps = kThreads / 32;
constexpr int kPerThread = 16;           // bits of the flag masks
constexpr int kMaxEdges = kThreads * kPerThread;
constexpr int kEdgeFloats = 7;           // Xw (3), uv (2), ur, inv_sigma2
constexpr int kSums = 28;                // H upper (21), b (6), cost
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr unsigned kFull = 0xffffffffu;
// named barriers (0 is __syncthreads'): the warps' sums are written; the
// next pose is written
constexpr int kBarSums = 1, kBarPose = 2;

struct Params {
  const float* R0;          // (3,3)
  const float* t0;          // (3,)
  const float* Xw;          // (N,3)
  const float* uv;          // (N,2)
  const float* ur;          // (N,)
  const float* isig;        // (N,)
  const unsigned char* stereo;  // (N,) bool
  const unsigned char* valid;   // (N,) bool
  float* R;                 // (3,3)
  float* t;                 // (3,)
  unsigned char* inliers;   // (N,) bool
  int* num_inliers;         // ()
  float* chi2;              // (N,)
  int N, rounds, iters;
  float fx, fy, cx, cy, bf;
};

// The staged edges: entry i of each array.
struct Edges {
  const float *X, *Y, *Z, *u, *v, *ur, *isig;
};

// which edges a pass counts, and whether it rewrites the active mask
enum Mode { kSetValid, kReclassify, kActive, kValid };

__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "r"(kThreads) : "memory");
}

// the clamps of the plain version: max(x, lo) that keeps a NaN
__device__ __forceinline__ float clamp_min(float x, float lo) {
  return x < lo ? lo : x;
}

__device__ __forceinline__ float safe_inv(float z, float eps) {
  return 1.f / (fabsf(z) < eps ? eps : z);
}

__device__ __forceinline__ float sched_scale(int h, int r) {
  if (h == 0 || r >= 3) return 1.f;
  return r == 0 ? 25.f : (r == 1 ? 9.f : 3.f);
}

__device__ __forceinline__ bool sched_huber(int h, int r) {
  return h == 1 || r < 2;
}

// Residual e (3) and chi2 of edge i at pose (R, t); Xc and the clamped
// inverse depths for the Jacobian.
struct EdgeEval {
  float x, y, z, iz, iz6;
  float e[3];
  float chi2;
};

__device__ __forceinline__ EdgeEval eval_edge(const Params& p, float X,
                                              float Y, float Z, float ou,
                                              float ov, float our, float isig,
                                              bool stereo, const float* R,
                                              const float* t) {
  EdgeEval v;
  v.x = R[0] * X + R[1] * Y + R[2] * Z + t[0];
  v.y = R[3] * X + R[4] * Y + R[5] * Z + t[1];
  v.z = R[6] * X + R[7] * Y + R[8] * Z + t[2];
  v.iz = safe_inv(v.z, 1e-9f);   // the camera's projection clamp
  v.iz6 = safe_inv(v.z, 1e-6f);  // the virtual right camera's clamp
  const float u = p.fx * v.x * v.iz + p.cx;
  const float vv = p.fy * v.y * v.iz + p.cy;
  v.e[0] = ou - u;
  v.e[1] = ov - vv;
  v.e[2] = our - (u - p.bf * v.iz6);
  float c = v.e[0] * v.e[0] + v.e[1] * v.e[1];
  if (stereo) c = c + v.e[2] * v.e[2];
  v.chi2 = c * isig;
  return v;
}

// Edge i of the staged (compacted) arrays.
__device__ __forceinline__ EdgeEval eval_staged(const Params& p,
                                                const Edges& E, int i,
                                                bool stereo, const float* R,
                                                const float* t) {
  return eval_edge(p, E.X[i], E.Y[i], E.Z[i], E.u[i], E.v[i], E.ur[i],
                   E.isig[i], stereo, R, t);
}

// Edge i of the inputs.
__device__ __forceinline__ EdgeEval eval_input(const Params& p, int i,
                                               bool stereo, const float* R,
                                               const float* t) {
  return eval_edge(p, p.Xw[3 * i], p.Xw[3 * i + 1], p.Xw[3 * i + 2],
                   p.uv[2 * i], p.uv[2 * i + 1], p.ur[i], p.isig[i], stereo,
                   R, t);
}

// One pass of a CTA over its edges at the pose in shared memory: this
// thread's partial sums of H (upper triangle, row major), b and the robust
// cost in acc.
__device__ __forceinline__ void edge_pass(const Params& p, const Edges& E, const float* pose,
                          Mode mode, unsigned valid, unsigned stereo,
                          unsigned& active, float cls_scale, bool huber,
                          float dscale, float acc[kSums]) {
  float R[9], t[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) R[k] = pose[k];
#pragma unroll
  for (int k = 0; k < 3; ++k) t[k] = pose[9 + k];
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  if (mode == kSetValid) active = valid;
  for (int j = 0; j < kPerThread; ++j) {
    if (!(valid >> j)) break;  // past this thread's last edge
    const int i = threadIdx.x + j * kThreads;
    const unsigned bit = 1u << j;
    // active is a subset of valid, so an invalid edge is never counted
    if (!(valid & bit) || (mode == kActive && !(active & bit))) continue;
    const bool st = (stereo & bit) != 0;
    const EdgeEval v = eval_staged(p, E, i, st, R, t);
    const float base = st ? kChi2Stereo : kChi2Mono;
    if (mode == kReclassify) {
      if (v.chi2 <= base * cls_scale) {
        active |= bit;
      } else {
        active &= ~bit;
        continue;
      }
    }
    const float d2 = base * dscale;
    const bool inside = !huber || v.chi2 <= d2;
    acc[27] += inside ? v.chi2
                      : 2.f * sqrtf(d2 * clamp_min(v.chi2, 0.f)) - d2;
    float w = E.isig[i];
    if (!inside) w = w * sqrtf(d2 / clamp_min(v.chi2, 1e-12f));
    // J = -(Jc [I | -hat(Xc)]), rows: u, v and (stereo) uR
    const float a0 = p.fx * v.iz, c0 = -p.fx * v.x * (v.iz * v.iz);
    const float b1 = p.fy * v.iz, c1 = -p.fy * v.y * (v.iz * v.iz);
    const float c2 = c0 + p.bf * v.iz6 * v.iz6;
    const int rows = st ? 3 : 2;
#pragma unroll
    for (int r = 0; r < 3; ++r) {
      if (r >= rows) break;
      const float a = r == 1 ? 0.f : a0;
      const float b = r == 1 ? b1 : 0.f;
      const float c = r == 0 ? c0 : (r == 1 ? c1 : c2);
      const float J[6] = {-a, -b, -c, b * v.z - c * v.y, -a * v.z + c * v.x,
                          a * v.y - b * v.x};
      int k = 0;
#pragma unroll
      for (int m = 0; m < 6; ++m) {
        const float wj = w * J[m];
#pragma unroll
        for (int n = m; n < 6; ++n) acc[k++] += wj * J[n];
        acc[21 + m] -= wj * v.e[r];
      }
    }
  }
}

// One level of warp_reduce_scatter: a lane keeps half of its O * 2
// values, sends the other half to its partner (lane ^ O) and adds the
// partner's. A template, so that every index is a constant and x stays in
// registers.
template <int O>
__device__ __forceinline__ void scatter_level(float (&x)[32], int lane) {
  const bool hi = (lane & O) != 0;
#pragma unroll
  for (int k = 0; k < O; ++k) {
    const float send = hi ? x[k] : x[k + O];
    const float keep = hi ? x[k + O] : x[k];
    x[k] = keep + __shfl_xor_sync(kFull, send, O);
  }
}

// The warp's sums of acc[0..kSums) over its 32 lanes, scattered: lane k <
// kSums returns the sum of value k (a fixed tree of 31 shuffles).
__device__ __forceinline__ float warp_reduce_scatter(const float acc[kSums]) {
  const int lane = threadIdx.x & 31;
  float x[32];
#pragma unroll
  for (int k = 0; k < 32; ++k) x[k] = k < kSums ? acc[k] : 0.f;
  scatter_level<16>(x, lane);
  scatter_level<8>(x, lane);
  scatter_level<4>(x, lane);
  scatter_level<2>(x, lane);
  scatter_level<1>(x, lane);
  return x[0];
}

// dx from the normal equations on warp 0's lanes: lane n < 6 holds column
// n of H in col[0..6), lane 6 holds b. Marquardt damping, Jacobi scaling,
// elimination with partial pivoting (the first largest entry of the
// column; rows scaled by the pivot's reciprocal, as LAPACK's getf2 does),
// back substitution; the same dx and the returned finiteness in every
// lane.
__device__ bool warp_lm_step(const float col[6], float lam, float dx[6]) {
  const int lane = threadIdx.x & 31;
  float a[6];
  float dg = 0.f;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    a[r] = col[r];
    if (lane == r) dg = a[r];
  }
  dg = dg + lam * dg + 1e-6f;
  const float sc = 1.f / sqrtf(dg + 1e-12f);
  float s[6];
#pragma unroll
  for (int r = 0; r < 6; ++r) s[r] = __shfl_sync(kFull, sc, r);
  const bool in_h = lane < 6;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    const float v = (lane == r) ? dg : a[r];
    a[r] = in_h ? v * s[r] * sc : v * s[r];
  }
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(a[c]);
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(a[r]) > best) {
        best = fabsf(a[r]);
        piv = r;
      }
    piv = __shfl_sync(kFull, piv, c);  // column c is lane c's
#pragma unroll
    for (int r = c + 1; r < 6; ++r)
      if (piv == r) {
        const float tmp = a[c];
        a[c] = a[r];
        a[r] = tmp;
      }
    float pc[6];
#pragma unroll
    for (int r = c; r < 6; ++r) pc[r] = __shfl_sync(kFull, a[r], c);
    const float inv_piv = 1.f / pc[c];
#pragma unroll
    for (int r = c + 1; r < 6; ++r) {
      const float f = pc[r] * inv_piv;
      a[r] -= f * a[c];
    }
  }
  // the upper triangle and the right-hand side in every lane
  float U[6][7];
#pragma unroll
  for (int m = 0; m < 6; ++m)
#pragma unroll
    for (int n = m; n < 7; ++n) U[m][n] = __shfl_sync(kFull, a[m], n);
  bool finite = true;
  float inv_u[6];  // the pivots' reciprocals, all at once
#pragma unroll
  for (int m = 0; m < 6; ++m) inv_u[m] = 1.f / U[m][m];
#pragma unroll
  for (int m = 5; m >= 0; --m) {
    float acc = U[m][6];
#pragma unroll
    for (int n = m + 1; n < 6; ++n) acc -= U[m][n] * dx[n];
    dx[m] = acc * inv_u[m];
  }
#pragma unroll
  for (int m = 0; m < 6; ++m) {
    dx[m] = dx[m] * s[m];
    finite = finite && isfinite(dx[m]);
  }
  return finite;
}

// T <- exp([rho, phi]) T, as ops/lie.se3_exp and se3_compose.
__device__ void se3_update(const float dx[6], const float* R, const float* t,
                           float* Rn, float* tn) {
  const float px = dx[3], py = dx[4], pz = dx[5];
  const float th2 = px * px + py * py + pz * pz;
  const float th = sqrtf(th2 + 1e-16f);
  const bool small = th2 < 1e-8f;
  float sn, cs;
  sincosf(th, &sn, &cs);
  const float a = small ? 1.f - th2 / 6.f : sn / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cs) / th2;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th);
  const float P[9] = {0.f, -pz, py, pz, 0.f, -px, -py, px, 0.f};
  float P2[9];
#pragma unroll
  for (int m = 0; m < 3; ++m)
#pragma unroll
    for (int n = 0; n < 3; ++n)
      P2[3 * m + n] = P[3 * m] * P[n] + P[3 * m + 1] * P[3 + n] +
                      P[3 * m + 2] * P[6 + n];
  float dR[9], V[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.f : 0.f;
    dR[k] = eye + a * P[k] + b * P2[k];
    V[k] = eye + b * P[k] + c * P2[k];
  }
#pragma unroll
  for (int m = 0; m < 3; ++m) {
#pragma unroll
    for (int n = 0; n < 3; ++n)
      Rn[3 * m + n] = dR[3 * m] * R[n] + dR[3 * m + 1] * R[3 + n] +
                      dR[3 * m + 2] * R[6 + n];
    tn[m] = (dR[3 * m] * t[0] + dR[3 * m + 1] * t[1] + dR[3 * m + 2] * t[2]) +
            (V[3 * m] * dx[0] + V[3 * m + 1] * dx[1] + V[3 * m + 2] * dx[2]);
  }
}

// The column of the normal equations lane n of warp 0 keeps, gathered from
// the lanes that hold the sums (lane k holds value k): column n of H for
// n < 6, b for lane 6.
__device__ __forceinline__ void gather_columns(float tot, float col[6]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int r = 0; r < 6; ++r) {
    int src = kSums - 1;
    if (lane < 6) {
      const int m = r < lane ? r : lane, n = r < lane ? lane : r;
      src = m * (11 - m) / 2 + n;  // (m, n) of the row-major upper triangle
    } else if (lane == 6) {
      src = 21 + r;
    }
    col[r] = __shfl_sync(kFull, tot, src);
  }
}

// Lanes 0-11 of a warp write the pose (R, t) to dst (unrolled, so the
// register arrays are never indexed by the lane).
__device__ __forceinline__ void write_pose(float* dst, const float R[9],
                                           const float t[3]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < 12; ++k)
    if (lane == k) dst[k] = k < 9 ? R[k] : t[k - 9];
}

// The exclusive prefix sum of v over the CTA's threads, and the total
// (every thread calls it; warp_tot: kWarps ints; one barrier).
__device__ int exclusive_scan(int v, int* warp_tot, int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int x = v;
  for (int o = 1; o < 32; o <<= 1) {
    const int y = __shfl_up_sync(kFull, x, o);
    if (lane >= o) x += y;
  }
  if (lane == 31) warp_tot[warp] = x;
  __syncthreads();
  int before = 0, all = 0;
  for (int w = 0; w < kWarps; ++w) {
    if (w < warp) before += warp_tot[w];
    all += warp_tot[w];
  }
  total = all;
  return before + x - v;
}

__device__ __forceinline__ bool pose_finite_t(const float* q) {
  return isfinite(q[10]) && isfinite(q[11]) && isfinite(q[12]);
}

__global__ void __cluster_dims__(2, 1, 1) __launch_bounds__(kThreads, 1)
pose_lm_kernel(const Params p) {
  extern __shared__ float staged[];
  __shared__ float red[kWarps][kSums];
  // before the passes, red holds the staged edges' stereo bits and the
  // staging's scan (the barrier before the first pass ends that use)
  static_assert(kMaxEdges / 32 + kWarps <= kWarps * kSums, "red too small");
  unsigned* st_bits = reinterpret_cast<unsigned*>(&red[0][0]);
  int* scan = reinterpret_cast<int*>(st_bits + kMaxEdges / 32);
  __shared__ float pose[12];       // the pose the next pass reads
  __shared__ float pub[13];        // the schedule's final cost and pose
  __shared__ int peer_count;       // the other CTA's inlier count

  cg::cluster_group cluster = cg::this_cluster();
  const int h = (int)cluster.block_rank();  // 0: schedule A, 1: B
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int N = p.N;
  const Edges E{staged, staged + N, staged + 2 * N, staged + 3 * N,
                staged + 4 * N, staged + 5 * N, staged + 6 * N};

  // The valid edges, compacted into shared memory in index order (a
  // thread's own edges, the threads in order), so that they spread evenly
  // over the threads; their stereo flags as bits.
  for (int w = tid; w < kMaxEdges / 32; w += kThreads) st_bits[w] = 0u;
  int nv = 0;
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i >= N) break;
    nv += p.valid[i] != 0;
  }
  int n_valid;
  int to = exclusive_scan(nv, scan, n_valid);
  for (int j = 0; j < kPerThread; ++j) {
    const int i = tid + j * kThreads;
    if (i >= N) break;
    if (!p.valid[i]) continue;
    staged[to] = p.Xw[3 * i];
    staged[N + to] = p.Xw[3 * i + 1];
    staged[2 * N + to] = p.Xw[3 * i + 2];
    staged[3 * N + to] = p.uv[2 * i];
    staged[4 * N + to] = p.uv[2 * i + 1];
    staged[5 * N + to] = p.ur[i];
    staged[6 * N + to] = p.isig[i];
    if (p.stereo[i]) atomicOr(&st_bits[to >> 5], 1u << (to & 31));
    ++to;
  }
  __syncthreads();
  // this thread's edges: k = tid, tid + kThreads, ... < n_valid
  unsigned valid = 0, stereo = 0, active = 0;
  for (int j = 0; j < kPerThread; ++j) {
    const int e = tid + j * kThreads;
    if (e >= n_valid) break;
    valid |= 1u << j;
    if ((st_bits[e >> 5] >> (e & 31)) & 1u) stereo |= 1u << j;
  }
  // warp 0's LM state, the same in each of its lanes but col (a column of
  // the normal equations per lane)
  float R[9], t[3], Rn[9], tn[3], col[6];
  float cost0 = 0.f, lam = 1e-3f;
  bool fin = false;
  if (warp == 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) R[k] = p.R0[k];
#pragma unroll
    for (int k = 0; k < 3; ++k) t[k] = p.t0[k];
    write_pose(pose, R, t);
  }
  __syncthreads();

  float acc[kSums];
  // passes: per round its start (the active set, the start cost and the
  // normal equations) and one per iteration at the trial pose; then the
  // final cost
  const int n_passes = p.rounds * (p.iters + 1) + 1;
  for (int q = 0; q < n_passes; ++q) {
    const bool final_pass = q == n_passes - 1;
    const int r = final_pass ? 0 : q / (p.iters + 1);
    const int it = final_pass ? 0 : q % (p.iters + 1) - 1;  // -1: the start
    const float dscale = final_pass ? 1.f : sched_scale(h, r);
    const bool huber = final_pass || sched_huber(h, r);
    const Mode mode = final_pass ? kValid
                      : it >= 0  ? kActive
                      : r == 0   ? kSetValid
                                 : kReclassify;
    edge_pass(p, E, pose, mode, valid, stereo, active, dscale, huber,
              dscale, acc);
    const float ws = warp_reduce_scatter(acc);
    if (lane < kSums) red[warp][lane] = ws;
    if (warp != 0) {
      bar_arrive(kBarSums);
      if (!final_pass) bar_sync(kBarPose);
      continue;
    }
    bar_sync(kBarSums);
    float tot = 0.f;
    if (lane < kSums)
      for (int w = 0; w < kWarps; ++w) tot += red[w][lane];
    const float cost = __shfl_sync(kFull, tot, kSums - 1);
    float c[6];
    gather_columns(tot, c);
    if (final_pass) {
      if (lane == 0) pub[0] = cost;
      write_pose(pub + 1, R, t);
      break;
    }
    if (it < 0 || (cost < cost0 && fin)) {
      if (it >= 0) {  // accepted: the trial is the state
#pragma unroll
        for (int k = 0; k < 9; ++k) R[k] = Rn[k];
#pragma unroll
        for (int k = 0; k < 3; ++k) t[k] = tn[k];
      }
#pragma unroll
      for (int k = 0; k < 6; ++k) col[k] = c[k];
      cost0 = cost;
      lam = it < 0 ? 1e-3f : lam * 0.5f;
    } else {
      lam = lam * 4.f;
    }
    if (it + 1 < p.iters) {  // the next pass is a trial
      float dx[6];
      fin = warp_lm_step(col, lam, dx);
      se3_update(dx, R, t, Rn, tn);
      write_pose(pose, Rn, tn);
    } else {  // the next round's start, or the final cost
      write_pose(pose, R, t);
    }
    __syncwarp();
    bar_arrive(kBarPose);
  }

  // the pick: both CTAs read both schedules' costs and poses
  cluster.sync();
  const float* a = cluster.map_shared_rank(pub, 0);
  const float* b = cluster.map_shared_rank(pub, 1);
  const bool pick_b = b[0] < a[0] && pose_finite_t(b);
  const float* won = pick_b ? b : a;
  float Rp[9], tp[3];
#pragma unroll
  for (int k = 0; k < 9; ++k) Rp[k] = won[1 + k];
#pragma unroll
  for (int k = 0; k < 3; ++k) tp[k] = won[10 + k];
  if (h == 0 && warp == 0) {
    write_pose(pose, Rp, tp);
    __syncwarp();
    if (lane < 9) p.R[lane] = pose[lane];
    else if (lane < 12) p.t[lane - 9] = pose[lane];
  }
  // the classification, CTA h taking every other block of kThreads edges
  int count = 0;
  for (int i0 = h * kThreads; i0 < N; i0 += 2 * kThreads) {
    const int i = i0 + tid;
    bool inl = false;
    if (i < N) {
      const bool st = p.stereo[i] != 0;
      const EdgeEval v = eval_input(p, i, st, Rp, tp);
      inl = p.valid[i] && v.chi2 <= (st ? kChi2Stereo : kChi2Mono);
      p.chi2[i] = v.chi2;
      p.inliers[i] = inl ? 1 : 0;
    }
    count += __syncthreads_count(inl);
  }
  // CTA 1 hands its count to CTA 0; nothing is read across CTAs after the
  // last cluster barrier
  if (h == 1 && tid == 0) *cluster.map_shared_rank(&peer_count, 0) = count;
  cluster.sync();
  if (h == 0 && tid == 0) *p.num_inliers = count + peer_count;
}

}  // namespace

extern "C" int pose_lm(const float* R0, const float* t0, const float* Xw,
                       const float* uv, const float* ur, const float* isig,
                       const unsigned char* stereo,
                       const unsigned char* valid, float* R, float* t,
                       unsigned char* inliers, int* num_inliers, float* chi2,
                       int N, int rounds, int iters, float fx, float fy,
                       float cx, float cy, float bf, void* stream) {
  if (N < 0 || N > kMaxEdges || rounds < 0 || iters < 0)
    return (int)cudaErrorInvalidValue;
  // the staged edges take dynamic shared memory beyond the default 48 KB:
  // allowed once per device for the most edges
  static bool allowed[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= 64) return (int)cudaErrorInvalidDevice;
  if (!allowed[dev]) {
    err = cudaFuncSetAttribute(
        pose_lm_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxEdges * kEdgeFloats * (int)sizeof(float));
    if (err != cudaSuccess) return (int)err;
    allowed[dev] = true;
  }
  const Params p{R0, t0, Xw, uv, ur, isig, stereo, valid, R, t, inliers,
                 num_inliers, chi2, N, rounds, iters, fx, fy, cx, cy, bf};
  const size_t smem = (size_t)N * kEdgeFloats * sizeof(float);
  pose_lm_kernel<<<2, kThreads, smem, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
