// The robust pose LM (Optimizer::PoseOptimization) in one launch.
//
// Replaces xfeatslam_tpu/optim/pose_opt.py pose_optimization (:82-193),
// which is XLA code, not Pallas: one jitted fori_loop program there. Its
// PyTorch counterpart (ops/cuda_kernels.pose_lm_plain) replays the same
// arithmetic as ~250 small ATen kernels per LM iteration, ~20,000 per
// call; this kernel does the whole call in one CTA.
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
// time is the chain of 2 x rounds x (iters + 1) dependent passes over the
// edges, each ending in a block reduction and a serial 6x6 solve.
//
// Design: one CTA of 512 threads, the schedules in its two halves (256
// threads each), run in lock step (every __syncthreads is reached by both).
// Thread l of a half owns edges l, l + 256, ...; its active flags are a
// 32-bit mask in a register (N <= 8192). A pass over the edges gives each
// thread its partial sums of the 21 upper-triangle entries of H, the 6 of
// b and the robust cost; a warp-shuffle reduction and a fixed-order sum of
// the 8 warps in shared memory give the half's totals. The first thread of
// each half then decides, solves and writes the next trial pose for the
// next pass. The pass at the trial pose gives the trial cost and also
// H and b there, which are the next iteration's normal equations when the
// step is accepted (on a reject the pose and so H and b stay), so an
// iteration is one pass, not two. After the rounds each half takes its
// Huber cost over the valid edges, the first thread picks, and the whole
// CTA writes chi2 and the inlier flags. No atomics, one summation order:
// an eager call and a graph replay give the same bits, as do two runs.
// Launched on the caller's stream; no allocation and no host sync.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kHalf = 256;               // threads per schedule
constexpr int kThreads = 2 * kHalf;
constexpr int kWarps = kThreads / 32;
constexpr int kWarpsHalf = kHalf / 32;
constexpr int kMaxPerThread = 32;        // bits of the active mask
constexpr int kMaxEdges = kHalf * kMaxPerThread;
constexpr int kSums = 28;                // H upper (21), b (6), cost
constexpr float kChi2Mono = 5.991f;
constexpr float kChi2Stereo = 7.815f;
constexpr unsigned kFull = 0xffffffffu;

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

// which edges a pass counts, and whether it rewrites the active mask
enum Mode { kSetValid, kReclassify, kActive, kValid };

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
  bool stereo, valid;
  float isig;
};

__device__ __forceinline__ EdgeEval eval_edge(const Params& p, int i,
                                              const float* R,
                                              const float* t) {
  EdgeEval v;
  const float X = __ldg(p.Xw + 3 * i), Y = __ldg(p.Xw + 3 * i + 1),
              Z = __ldg(p.Xw + 3 * i + 2);
  v.x = R[0] * X + R[1] * Y + R[2] * Z + t[0];
  v.y = R[3] * X + R[4] * Y + R[5] * Z + t[1];
  v.z = R[6] * X + R[7] * Y + R[8] * Z + t[2];
  v.iz = safe_inv(v.z, 1e-9f);   // the camera's projection clamp
  v.iz6 = safe_inv(v.z, 1e-6f);  // the virtual right camera's clamp
  const float u = p.fx * v.x * v.iz + p.cx;
  const float vv = p.fy * v.y * v.iz + p.cy;
  v.e[0] = __ldg(p.uv + 2 * i) - u;
  v.e[1] = __ldg(p.uv + 2 * i + 1) - vv;
  v.e[2] = __ldg(p.ur + i) - (u - p.bf * v.iz6);
  v.stereo = __ldg(p.stereo + i) != 0;
  v.valid = __ldg(p.valid + i) != 0;
  v.isig = __ldg(p.isig + i);
  float c = v.e[0] * v.e[0] + v.e[1] * v.e[1];
  if (v.stereo) c = c + v.e[2] * v.e[2];
  v.chi2 = c * v.isig;
  return v;
}

// One pass of a half over its edges at pose (R, t): each thread's partial
// sums of H (upper triangle, row major), b and the robust cost in acc.
__device__ void edge_pass(const Params& p, int lt, const float* R,
                          const float* t, Mode mode, unsigned& active,
                          float cls_scale, bool huber, float dscale,
                          float acc[kSums]) {
#pragma unroll
  for (int k = 0; k < kSums; ++k) acc[k] = 0.f;
  for (int j = 0; j < kMaxPerThread; ++j) {
    const int i = lt + j * kHalf;
    if (i >= p.N) break;
    const EdgeEval v = eval_edge(p, i, R, t);
    const float base = v.stereo ? kChi2Stereo : kChi2Mono;
    bool on;
    if (mode == kSetValid || mode == kReclassify) {
      on = v.valid && (mode == kSetValid || v.chi2 <= base * cls_scale);
      active = on ? (active | (1u << j)) : (active & ~(1u << j));
    } else if (mode == kActive) {
      on = (active >> j) & 1u;
    } else {
      on = v.valid;
    }
    if (!on) continue;
    const float d2 = base * dscale;
    const bool inside = !huber || v.chi2 <= d2;
    acc[27] += inside ? v.chi2
                      : 2.f * sqrtf(d2 * clamp_min(v.chi2, 0.f)) - d2;
    float w = v.isig;
    if (!inside) w = w * sqrtf(d2 / clamp_min(v.chi2, 1e-12f));
    // J = -(Jc [I | -hat(Xc)]), rows: u, v and (stereo) uR
    const float a0 = p.fx * v.iz, c0 = -p.fx * v.x * (v.iz * v.iz);
    const float b1 = p.fy * v.iz, c1 = -p.fy * v.y * (v.iz * v.iz);
    const float c2 = c0 + p.bf * v.iz6 * v.iz6;
    const int rows = v.stereo ? 3 : 2;
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

// The CTA's sums: lane 0 of each warp after a shuffle reduction, then the
// 8 warps of each half in order. Every thread of the CTA must call it.
__device__ void block_sums(float acc[kSums], float (*red)[kSums],
                           float (*tot)[kSums]) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int k = 0; k < kSums; ++k) {
    float s = acc[k];
    for (int o = 16; o > 0; o >>= 1) s += __shfl_down_sync(kFull, s, o);
    acc[k] = s;
  }
  if (lane == 0) {
#pragma unroll
    for (int k = 0; k < kSums; ++k) red[warp][k] = acc[k];
  }
  __syncthreads();
  if (threadIdx.x < 2 * kSums) {
    const int h = threadIdx.x / kSums, k = threadIdx.x % kSums;
    float s = 0.f;
    for (int w = 0; w < kWarpsHalf; ++w) s += red[h * kWarpsHalf + w][k];
    tot[h][k] = s;
  }
  __syncthreads();
}

// dx from the normal equations: Marquardt damping, Jacobi scaling, LU
// with partial pivoting. Returns whether every entry is finite.
__device__ bool lm_step(const float* Hu, const float* bv, float lam,
                        float dx[6]) {
  float A[6][7];
  float s[6];
  int k = 0;
  for (int m = 0; m < 6; ++m)
    for (int n = m; n < 6; ++n) {
      A[m][n] = Hu[k];
      A[n][m] = Hu[k];
      ++k;
    }
  for (int m = 0; m < 6; ++m) {
    A[m][m] = A[m][m] + lam * A[m][m] + 1e-6f;
    s[m] = 1.f / sqrtf(A[m][m] + 1e-12f);
  }
  for (int m = 0; m < 6; ++m) {
    for (int n = 0; n < 6; ++n) A[m][n] = A[m][n] * s[m] * s[n];
    A[m][6] = bv[m] * s[m];
  }
  for (int c = 0; c < 6; ++c) {
    int piv = c;
    float best = fabsf(A[c][c]);
    for (int r = c + 1; r < 6; ++r)
      if (fabsf(A[r][c]) > best) {
        best = fabsf(A[r][c]);
        piv = r;
      }
    if (piv != c)
      for (int n = c; n < 7; ++n) {
        const float tmp = A[c][n];
        A[c][n] = A[piv][n];
        A[piv][n] = tmp;
      }
    for (int r = c + 1; r < 6; ++r) {
      const float f = A[r][c] / A[c][c];
      for (int n = c; n < 7; ++n) A[r][n] -= f * A[c][n];
    }
  }
  bool finite = true;
  for (int m = 5; m >= 0; --m) {
    float acc = A[m][6];
    for (int n = m + 1; n < 6; ++n) acc -= A[m][n] * dx[n];
    dx[m] = acc / A[m][m];
  }
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
  const float sn = sinf(th), cs = cosf(th);
  const float a = small ? 1.f - th2 / 6.f : sn / th;
  const float b = small ? 0.5f - th2 / 24.f : (1.f - cs) / th2;
  const float c = small ? 1.f / 6.f - th2 / 120.f : (th - sn) / (th2 * th);
  const float P[9] = {0.f, -pz, py, pz, 0.f, -px, -py, px, 0.f};
  float P2[9];
  for (int m = 0; m < 3; ++m)
    for (int n = 0; n < 3; ++n)
      P2[3 * m + n] = P[3 * m] * P[n] + P[3 * m + 1] * P[3 + n] +
                      P[3 * m + 2] * P[6 + n];
  float dR[9], V[9];
  for (int k = 0; k < 9; ++k) {
    const float eye = (k % 4 == 0) ? 1.f : 0.f;
    dR[k] = eye + a * P[k] + b * P2[k];
    V[k] = eye + b * P[k] + c * P2[k];
  }
  for (int m = 0; m < 3; ++m) {
    for (int n = 0; n < 3; ++n)
      Rn[3 * m + n] = dR[3 * m] * R[n] + dR[3 * m + 1] * R[3 + n] +
                      dR[3 * m + 2] * R[6 + n];
    tn[m] = (dR[3 * m] * t[0] + dR[3 * m + 1] * t[1] + dR[3 * m + 2] * t[2]) +
            (V[3 * m] * dx[0] + V[3 * m + 1] * dx[1] + V[3 * m + 2] * dx[2]);
  }
}

__device__ __forceinline__ void put_pose(float* dst, const float* R,
                                         const float* t) {
  for (int k = 0; k < 9; ++k) dst[k] = R[k];
  for (int k = 0; k < 3; ++k) dst[9 + k] = t[k];
}

__device__ __forceinline__ void get_pose(const float* src, float* R,
                                         float* t) {
  for (int k = 0; k < 9; ++k) R[k] = src[k];
  for (int k = 0; k < 3; ++k) t[k] = src[9 + k];
}

__global__ void __launch_bounds__(kThreads)
pose_lm_kernel(const Params p) {
  __shared__ float red[kWarps][kSums];
  __shared__ float tot[2][kSums];
  __shared__ float pose[2][12];    // the pose each half's next pass reads
  __shared__ float final_cost[2];

  const int h = threadIdx.x / kHalf;
  const int lt = threadIdx.x % kHalf;
  const bool lead = lt == 0;
  // the accepted state, held by each half's first thread
  float R[9], t[3], Hu[21], bv[6], cost0 = 0.f, lam = 1e-3f;
  if (lead) {
    for (int k = 0; k < 9; ++k) R[k] = p.R0[k];
    for (int k = 0; k < 3; ++k) t[k] = p.t0[k];
  }
  unsigned active = 0;
  float acc[kSums];
  float Rp[9], tp[3];

  for (int r = 0; r < p.rounds; ++r) {
    const float dscale = sched_scale(h, r);
    const bool huber = sched_huber(h, r);
    if (lead) put_pose(pose[h], R, t);
    __syncthreads();
    get_pose(pose[h], Rp, tp);
    // the round's active edges (from round 1: chi2 at the round's start
    // against its width), its start cost and normal equations
    edge_pass(p, lt, Rp, tp, r == 0 ? kSetValid : kReclassify, active,
              dscale, huber, dscale, acc);
    block_sums(acc, red, tot);
    float Rn[9], tn[3];
    bool fin = false;
    if (lead) {
      for (int k = 0; k < 21; ++k) Hu[k] = tot[h][k];
      for (int k = 0; k < 6; ++k) bv[k] = tot[h][21 + k];
      cost0 = tot[h][27];
      lam = 1e-3f;
    }
    for (int it = 0; it < p.iters; ++it) {
      if (lead) {
        float dx[6];
        fin = lm_step(Hu, bv, lam, dx);
        se3_update(dx, R, t, Rn, tn);
        put_pose(pose[h], Rn, tn);
      }
      __syncthreads();
      get_pose(pose[h], Rp, tp);
      edge_pass(p, lt, Rp, tp, kActive, active, 1.f, huber, dscale, acc);
      block_sums(acc, red, tot);
      if (lead) {
        const float cost1 = tot[h][27];
        if (cost1 < cost0 && fin) {
          for (int k = 0; k < 9; ++k) R[k] = Rn[k];
          for (int k = 0; k < 3; ++k) t[k] = tn[k];
          for (int k = 0; k < 21; ++k) Hu[k] = tot[h][k];
          for (int k = 0; k < 6; ++k) bv[k] = tot[h][21 + k];
          cost0 = cost1;
          lam = lam * 0.5f;
        } else {
          lam = lam * 4.f;
        }
      }
    }
  }

  // each schedule's Huber cost over the valid edges, then the pick
  if (lead) put_pose(pose[h], R, t);
  __syncthreads();
  get_pose(pose[h], Rp, tp);
  edge_pass(p, lt, Rp, tp, kValid, active, 1.f, true, 1.f, acc);
  block_sums(acc, red, tot);
  if (threadIdx.x == 0) {
    final_cost[0] = tot[0][27];
    final_cost[1] = tot[1][27];
    const bool tb_finite = isfinite(pose[1][9]) && isfinite(pose[1][10]) &&
                           isfinite(pose[1][11]);
    const int pick = (final_cost[1] < final_cost[0] && tb_finite) ? 1 : 0;
    for (int k = 0; k < 12; ++k) pose[0][k] = pose[pick][k];
    for (int k = 0; k < 9; ++k) p.R[k] = pose[0][k];
    for (int k = 0; k < 3; ++k) p.t[k] = pose[0][9 + k];
  }
  __syncthreads();
  get_pose(pose[0], Rp, tp);
  int count = 0;
  for (int i0 = 0; i0 < p.N; i0 += kThreads) {
    const int i = i0 + threadIdx.x;
    bool inl = false;
    if (i < p.N) {
      const EdgeEval v = eval_edge(p, i, Rp, tp);
      inl = v.valid && v.chi2 <= (v.stereo ? kChi2Stereo : kChi2Mono);
      p.chi2[i] = v.chi2;
      p.inliers[i] = inl ? 1 : 0;
    }
    count += __syncthreads_count(inl);
  }
  if (threadIdx.x == 0) *p.num_inliers = count;
}

}  // namespace

extern "C" int pose_lm(const float* R0, const float* t0, const float* Xw,
                       const float* uv, const float* ur, const float* isig,
                       const unsigned char* stereo,
                       const unsigned char* valid, float* R, float* t,
                       unsigned char* inliers, int* num_inliers, float* chi2,
                       int N, int rounds, int iters, float fx, float fy,
                       float cx, float cy, float bf, void* stream) {
  if (N < 0 || N > kMaxEdges) return (int)cudaErrorInvalidValue;
  const Params p{R0, t0, Xw, uv, ur, isig, stereo, valid, R, t, inliers,
                 num_inliers, chi2, N, rounds, iters, fx, fy, cx, cy, bf};
  pose_lm_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
