// GICP IRLS iteration (K2) and nearest valid target (K8) for Hopper (sm_90a):
// the CUDA port of the Pallas kernels graphslam_tpu/ops/icp_kernel.py::_kernel
// and graphslam_tpu/ops/correspondence.py::_nn_kernel.
//
// For every source point, the nearest valid target:
//
//   * exact coordinate differences, d2 = dx*dx + dy*dy with each product and
//     the sum rounded on its own (no FMA contraction, never |a|^2+|b|^2-2ab),
//     so the distances are bit for bit those of the plain torch twin;
//   * argmin semantics: the first index of the minimum; invalid targets read
//     `big` (3.4e38 for K2 as icp_kernel.py:45, +inf for K8 as
//     correspondence.py:47), so with no valid target the index is 0.
//
// K2 then reads the matched target's surfel covariance, inverts the 2x2
// combined covariance (|det| < 1e-20 clamped) and reduces the 13 sums
// [H upper 6, g 3, sum_d2_all, sum_d2_gated, n_match, sum_mahal] without
// atomics: a fixed-order tree over each 64-point block, then the block
// partials in block order. Two runs give bitwise equal results.
//
// Two launch shapes run K2:
//
//   icp_match, icp_iteration   ONE launch of k_icp_rounds (a whole IRLS
//       loop of frontend/icp.py::gicp_match, or one round on given moved
//       points) on one thread-block cluster of kLoopThreads-thread CTAs
//       (csrc/persistent.cuh; 16 CTAs of 72 points at P = 1152, 128 a
//       pass). Each CTA stages the targets (x, y, valid, covariance) in
//       shared memory once a match where they fit (kLoopTile), else tile
//       by tile every pass. Each source point gets a group of kGroup
//       threads: thread g scans targets g, g + kGroup, ..., and the group
//       combines (d2, index) by shuffles into the first index of the
//       smallest distance below +inf, or target 0 where there is none or
//       its distance is NaN: the serial scan's result in every case
//       (group_nearest). The group's thread 0 writes the point's 13
//       values to a row buffer; after the cluster barrier every CTA forms
//       each 64-point block's tree in one warp (block_reduce_store's pairs
//       in block_reduce_store's order), adds the blocks in order as
//       k_icp_finish does, and runs the GN update itself (CTA 0 writes
//       delta, out and ctrl), so one barrier a round suffices: the row
//       buffer alternates between two halves by round. With early exit the
//       loop ends on every CTA after the round whose |upd| < tol (a NaN
//       stops it, as jax.lax.while_loop's cond): no later round runs.
//   icp_match_staged, icp_iteration_staged   the yardstick: per round
//       k_icp_iter (one thread a point scanning every target, 64-point
//       blocks) and k_icp_finish (one thread), 2 x `iterations` launches a
//       match, the rounds after convergence returning at their first line.
//       Both shapes call one compiled body (__noinline__) for a point's
//       inputs, a point's 13 values and the GN update, so they round alike:
//       delta, out and ctrl are bitwise equal.
//
// What bounds it on an H100 at P = Q = 1152: one round is 1.3M distance
// evaluations (~7 MFLOP, ~0.1 us at the card's float32 peak) on ~60 KB of
// inputs, so neither bytes nor the card's FLOPs bound it. The staged shape
// paid two launches a round on 18 blocks of one thread a point scanning
// 1152 targets (~55 us a round). The persistent one pays a cluster barrier
// a round, and its scan is bound by the instructions the cluster's 16 SMs
// issue (~6 us of a ~12.6 us round, PERF.md): so a target's x, y and valid
// flag are one float4 load, a thread compares strictly within its slice
// and the tie rule runs only in the shuffles, and groups without a point
// skip the scan.
//
// K8 (nn_search: k_nn) takes group_nearest on a plain grid, a group of
// kNnGroup threads a source point on CTAs of kNnThreads, each CTA staging
// the targets tile by tile; its yardstick nn_search_serial (k_nn_serial)
// keeps the old shape, one thread a point scanning every target through
// block_nearest. Both give bitwise the same index and distance.
//
// Plain C interface for ctypes: device pointers in a struct, launches on
// problem->stream, each function returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "persistent.cuh"

extern "C" {

struct IcpProblem {
  const float* pts;                // (P, 2) loop: source points; one round: moved points
  const float* jtheta;             // (P, 2) one round only: dR/dtheta @ source point
  const float* cov;                // (P, 3) loop: source surfel covs [a, b, d];
                                   //        one round: rotated [c11, c12, c22]
  const unsigned char* src_mask;   // (P,) bool
  const float* tgt;                // (Q, 2)
  const unsigned char* tgt_valid;  // (Q,) bool
  const float* ct;                 // (Q, 3) target surfel covs [c11, c12, c22]
  float* partials;                 // (point_blocks(P), kLanes) staged shape's block sums
  float* rows;                     // (2, kSums, P) persistent shape's point values
  float* delta;                    // (3,) loop: in/out estimate
  float* out;                      // (kLanes,) see icp_iteration / icp_match
  int* ctrl;                       // (2,) loop: [done, rounds run]
  void* stream;                    // cudaStream_t
  int P, Q;
  float max_corr2, eps, tol;
};

}  // extern "C"

namespace {

constexpr int kBlock = 64;     // source points per block of the sums' tree
constexpr int kTile = 2048;    // targets staged in shared memory at a time (staged shape)
constexpr int kLanes = 16;     // 13 sums, padded
constexpr int kSums = 13;
constexpr float kBigIcp = 3.4e38f;

// The persistent shape: CTAs of kLoopThreads threads, a group of kGroup
// threads a source point, kLoopTile targets resident in shared memory.
constexpr int kLoopThreads = 1024;
constexpr int kGroup = 8;
constexpr int kGroupsPerCta = kLoopThreads / kGroup;
constexpr int kLoopTile = 1536;
static_assert(32 % kGroup == 0, "a group lies in one warp");
static_assert(kLoopThreads % 32 == 0, "whole warps");

__host__ __device__ inline int point_blocks(int n) { return (n + kBlock - 1) / kBlock; }

// CTAs of the persistent launch over P points: kMaxClusterCtas, fewer only
// where there are fewer points. CTA c takes the points [c, c + 1) x
// ceil(P / CTAs), kGroupsPerCta a pass.
inline int loop_ctas(int P) {
  return P < 1 ? 1 : P < kMaxClusterCtas ? P : kMaxClusterCtas;
}

struct Nearest {
  float d2;
  int idx;
};

__device__ __forceinline__ float dist2(float mx, float my, float x, float y) {
  const float dx = mx - x;
  const float dy = my - y;
  return __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
}

// Nearest target of (mx, my) among the Q targets, invalid ones reading `big`.
// Every thread of the block calls it (it synchronises); a thread past the
// last point passes any coordinates and ignores the result.
__device__ Nearest block_nearest(float mx, float my, const float* tgt,
                                 const unsigned char* valid, int Q, float big) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ unsigned char sv[kTile];
  Nearest best{big, 0};
  for (int base = 0; base < Q; base += kTile) {
    const int n = Q - base < kTile ? Q - base : kTile;
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      sx[j] = tgt[2 * (base + j)];
      sy[j] = tgt[2 * (base + j) + 1];
      sv[j] = valid[base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float d2 = sv[j] ? dist2(mx, my, sx[j], sy[j]) : big;
      if ((base == 0 && j == 0) || d2 < best.d2) {
        best.d2 = d2;
        best.idx = base + j;
      }
    }
  }
  return best;
}

// A source point's inputs to a round: its moved position, dR/dtheta @ point
// and rotated covariance [c11, c12, c22].
struct RoundIn {
  float mx, my, jx, jy, s11, s12, s22;
};

// The __noinline__ bodies below are called by both launch shapes, so that
// both round alike (nvcc may contract a source to FMAs differently inside
// kernels of other shapes).

// Point i's inputs (icp_kernel.py:38-101). kLoop: moved from the source
// point at the estimate (d0, d1, d2) (icp.py:184-199); else as given.
template <bool kLoop>
__device__ __noinline__ RoundIn round_in(const IcpProblem& p, int i, float d0, float d1,
                                         float d2) {
  RoundIn r;
  const float x = p.pts[2 * i], y = p.pts[2 * i + 1];
  const float a = p.cov[3 * i], b = p.cov[3 * i + 1], d = p.cov[3 * i + 2];
  if (kLoop) {
    const float c = cosf(d2), s = sinf(d2);
    r.mx = c * x - s * y + d0;
    r.my = s * x + c * y + d1;
    r.jx = -s * x - c * y;
    r.jy = c * x - s * y;
    r.s11 = c * c * a - 2.f * c * s * b + s * s * d;
    r.s12 = c * s * (a - d) + (c * c - s * s) * b;
    r.s22 = s * s * a + 2.f * c * s * b + c * c * d;
  } else {
    r.mx = x;
    r.my = y;
    r.jx = p.jtheta[2 * i];
    r.jy = p.jtheta[2 * i + 1];
    r.s11 = a;
    r.s12 = b;
    r.s22 = d;
  }
  return r;
}

struct Sums {
  float v[kSums];
};

// Point i's 13 values, matched to the target at (qx, qy) of covariance
// [t11, t12, t22] at squared distance nd2.
__device__ __noinline__ Sums point_sums(const IcpProblem& p, int i, const RoundIn& in,
                                        float nd2, float qx, float qy, float t11, float t12,
                                        float t22) {
  Sums out;
  const bool sm = p.src_mask[i] != 0;
  const bool w = nd2 < kBigIcp * 0.5f && sm && nd2 <= p.max_corr2;
  const float wf = w ? 1.f : 0.f;
  const float wall = sm ? 1.f : 0.f;
  const float c11 = t11 + in.s11 + p.eps;
  const float c12 = t12 + in.s12;
  const float c22 = t22 + in.s22 + p.eps;
  float det = c11 * c22 - c12 * c12;
  if (fabsf(det) < 1e-20f) det = 1e-20f;
  const float m11 = c22 / det, m12 = -c12 / det, m22 = c11 / det;
  const float ex = qx - in.mx, ey = qy - in.my;
  const float jx = in.jx, jy = in.jy;
  const float me1 = m11 * ex + m12 * ey;
  const float me2 = m12 * ex + m22 * ey;
  const float d2c = fminf(nd2, 1e9f);
  float* v = out.v;
  v[0] = wf * m11;
  v[1] = wf * m12;
  v[2] = wf * m22;
  v[3] = wf * (m11 * jx + m12 * jy);
  v[4] = wf * (m12 * jx + m22 * jy);
  v[5] = wf * (jx * jx * m11 + 2.f * jx * jy * m12 + jy * jy * m22);
  v[6] = wf * me1;
  v[7] = wf * me2;
  v[8] = wf * (jx * me1 + jy * me2);
  v[9] = wall * d2c;
  v[10] = wf * d2c;
  v[11] = wf;
  v[12] = wf * (ex * me1 + ey * me2);
  return out;
}

// Sum v[k] over the block's threads in a fixed tree order; thread 0 writes
// the block's partials.
__device__ void block_reduce_store(const float (&v)[kSums], float* partials) {
  __shared__ float red[kSums][kBlock];
  const int t = threadIdx.x;
  for (int k = 0; k < kSums; ++k) red[k][t] = v[k];
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int k = 0; k < kSums; ++k) red[k][t] += red[k][t + s];
    __syncthreads();
  }
  if (t == 0)
    for (int k = 0; k < kLanes; ++k)
      partials[blockIdx.x * kLanes + k] = k < kSums ? red[k][0] : 0.0f;
}

// One IRLS round's block partials, staged shape. kLoop: the moved points,
// jtheta and rotated source covariances come from p.delta.
template <bool kLoop>
__global__ void k_icp_iter(IcpProblem p, int early_exit) {
  if (kLoop && early_exit && p.ctrl[0]) return;  // uniform over the grid
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < p.P;
  RoundIn in{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
  if (live)
    in = round_in<kLoop>(p, i, kLoop ? p.delta[0] : 0.f, kLoop ? p.delta[1] : 0.f,
                         kLoop ? p.delta[2] : 0.f);
  const Nearest nn = block_nearest(in.mx, in.my, p.tgt, p.tgt_valid, p.Q, kBigIcp);
  Sums v{};
  if (live)
    v = point_sums(p, i, in, nn.d2, p.tgt[2 * nn.idx], p.tgt[2 * nn.idx + 1], p.ct[3 * nn.idx],
                   p.ct[3 * nn.idx + 1], p.ct[3 * nn.idx + 2]);
  block_reduce_store(v.v, p.partials);
}

// Solve the 3x3 system A x = b by Gaussian elimination with partial pivoting
// (the first largest |pivot|, as LAPACK's getrf picks it). Every index is
// static after unrolling (the pivot row is swapped in by a compare per
// row), so M stays in registers.
__device__ void solve3(const float (&A)[3][3], const float (&b)[3], float (&x)[3]) {
  float M[3][4];
#pragma unroll
  for (int r = 0; r < 3; ++r) {
#pragma unroll
    for (int c = 0; c < 3; ++c) M[r][c] = A[r][c];
    M[r][3] = b[r];
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int piv = k;
    float top = fabsf(M[k][k]);
#pragma unroll
    for (int r = k + 1; r < 3; ++r)
      if (fabsf(M[r][k]) > top) {
        piv = r;
        top = fabsf(M[r][k]);
      }
#pragma unroll
    for (int r = k + 1; r < 3; ++r)
      if (r == piv)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const float t = M[k][c];
          M[k][c] = M[r][c];
          M[r][c] = t;
        }
#pragma unroll
    for (int r = k + 1; r < 3; ++r) {
      const float f = M[r][k] / M[k][k];
#pragma unroll
      for (int c = k; c < 4; ++c) M[r][c] -= f * M[k][c];
    }
  }
#pragma unroll
  for (int r = 2; r >= 0; --r) {
    float s = M[r][3];
#pragma unroll
    for (int c = r + 1; c < 3; ++c) s -= M[r][c] * x[c];
    x[r] = s / M[r][r];
  }
}

// The GN update of delta (icp.py:205-210) from the round's sums: delta in
// place, out = [H + 1e-6 I (9, row-major), stats (4), |upd|]; returns |upd|.
__device__ __noinline__ float icp_update(const float* acc, float* delta, float* out) {
  const float H[3][3] = {{acc[0] + 1e-6f, acc[1], acc[3]},
                         {acc[1], acc[2] + 1e-6f, acc[4]},
                         {acc[3], acc[4], acc[5] + 1e-6f}};
  const float g[3] = {acc[6], acc[7], acc[8]};
  float upd[3];
  solve3(H, g, upd);
  const float th = delta[2] + upd[2];
  delta[0] += upd[0];
  delta[1] += upd[1];
  delta[2] = atan2f(sinf(th), cosf(th));
  const float norm = sqrtf(upd[0] * upd[0] + upd[1] * upd[1] + upd[2] * upd[2]);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) out[3 * r + c] = H[r][c];
  for (int k = 0; k < 4; ++k) out[9 + k] = acc[9 + k];
  out[13] = norm;
  return norm;
}

// One thread, staged shape: the block partials summed in block order. One
// round: out[0:13] = the sums. Loop: icp_update, ctrl[1] += 1, and the
// early-exit flag.
template <bool kLoop>
__global__ void k_icp_finish(IcpProblem p, int nb, int early_exit) {
  if (kLoop && early_exit && p.ctrl[0]) return;
  float acc[kSums];
  for (int k = 0; k < kSums; ++k) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += p.partials[b * kLanes + k];
    acc[k] = s;
  }
  if (!kLoop) {
    for (int k = 0; k < kLanes; ++k) p.out[k] = k < kSums ? acc[k] : 0.f;
    return;
  }
  const float norm = icp_update(acc, p.delta, p.out);
  p.ctrl[1] += 1;
  // while_loop's cond is (k < iterations) & (|upd| >= tol): a NaN stops it.
  if (early_exit && !(norm >= p.tol)) p.ctrl[0] = 1;
}

// ---------------------------------------------------------------------------
// The persistent shape: k_icp_rounds
// ---------------------------------------------------------------------------

// Targets [base, base + n) into the CTA's shared tile as (x, y, valid, 0);
// extra(j, base + j) stages what else a caller keeps of target base + j.
template <typename F>
__device__ __forceinline__ void stage_tile(const float* tgt, const unsigned char* valid, int base,
                                           int n, float4* st, F extra) {
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    float4 t;
    t.x = tgt[2 * (base + j)];
    t.y = tgt[2 * (base + j) + 1];
    t.z = valid[base + j] ? 1.f : 0.f;
    t.w = 0.f;
    st[j] = t;
    extra(j, base + j);
  }
}

// What K2 stages of a target beside the tile: its covariance [c11, c12,
// c22] into sc.
struct CovStager {
  const IcpProblem& p;
  float* sc;
  __device__ __forceinline__ void operator()(int j, int q) const {
    sc[3 * j] = p.ct[3 * q];
    sc[3 * j + 1] = p.ct[3 * q + 1];
    sc[3 * j + 2] = p.ct[3 * q + 2];
  }
};

// No target yet: any distance below +inf comes first.
constexpr int kNone = 0x7fffffff;

// (d, i) comes before best: a smaller distance, or the same at a smaller
// index. A NaN distance never comes before anything.
__device__ __forceinline__ bool before(float d, int i, const Nearest& best) {
  return d < best.d2 || (d == best.d2 && i < best.idx);
}

// Thread g of a group of G: targets base + g, base + g + G, ... of the
// tile, in index order, invalid ones reading `big`; it keeps the first of
// its smallest distances below +inf.
template <int G>
__device__ __forceinline__ void scan_tile(float mx, float my, int g, int base, int n,
                                          const float4* st, float big, Nearest& best) {
#pragma unroll 4
  for (int j = g; j < n; j += G) {
    const float4 t = st[j];
    const float d2 = t.z != 0.f ? dist2(mx, my, t.x, t.y) : big;
    if (d2 < best.d2) best = Nearest{d2, base + j};
  }
}

// The nearest of the Q targets (invalid ones reading `big`) to the group's
// point (mx, my), on thread g = 0 of its group of G threads (live: the
// group has a point; the others scan nothing). The group's threads scan
// interleaved slices and combine (d2, index) by shuffles into the first
// index of the smallest distance below +inf; where there is none, or where
// the distance to target 0 is NaN, index 0 with that distance. That is
// block_nearest's serial scan in every case: it takes target 0 first and
// then only strictly smaller distances, which a NaN never is and +inf is
// not after a distance of +inf. With whole, the Q targets are in the
// shared tile st already; else every thread of the CTA stages them tile
// by tile (kLoopTile, extra as stage_tile's), __syncthreads between
// tiles. Every thread of the CTA calls it (shuffles over full warps).
template <int G, typename F>
__device__ Nearest group_nearest(const float* tgt, const unsigned char* valid, int Q, float big,
                                 bool live, float mx, float my, int g, bool whole, float4* st,
                                 F extra) {
  static_assert(32 % G == 0, "a group lies in one warp");
  Nearest best{INFINITY, kNone};
  if (whole) {
    if (live) scan_tile<G>(mx, my, g, 0, Q, st, big, best);
  } else {
    for (int base = 0; base < Q; base += kLoopTile) {
      const int n = Q - base < kLoopTile ? Q - base : kLoopTile;
      __syncthreads();  // the previous tile is consumed
      stage_tile(tgt, valid, base, n, st, extra);
      __syncthreads();
      if (live) scan_tile<G>(mx, my, g, base, n, st, big, best);
    }
  }
  for (int off = G / 2; off > 0; off >>= 1) {
    const float d = __shfl_down_sync(0xffffffffu, best.d2, off);
    const int i = __shfl_down_sync(0xffffffffu, best.idx, off);
    if (before(d, i, best)) best = Nearest{d, i};
  }
  const float d0 = valid[0] ? dist2(mx, my, tgt[0], tgt[1]) : big;
  if (d0 != d0 || best.idx == kNone) best = Nearest{d0, 0};
  return best;
}

// The 13 sums of rows (kSums, P) in the staged shape's order, on every
// thread: each 64-point block's block_reduce_store tree (one warp a block:
// the pair t, t + 32 in registers, then strides 16 .. 1 across lanes), the
// blocks added in index order from 0.f as k_icp_finish adds them (sum k on
// thread k). Every thread of the CTA calls it.
__device__ void rows_sum(const float* rows, int P, float (&acc)[kSums]) {
  __shared__ float part[kLoopThreads / 32][kSums];
  __shared__ float total[kSums];
  const int nb = point_blocks(P), warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float sum_k = 0.f;
  for (int b0 = 0; b0 < nb; b0 += warps) {
    const int i0 = (b0 + warp) * kBlock + lane, i1 = i0 + 32;
    const bool on = b0 + warp < nb;
    float x[kSums];
#pragma unroll
    for (int k = 0; k < kSums; ++k) {  // every load issued before the first add
      const float a = on && i0 < P ? rows[(long long)k * P + i0] : 0.f;
      const float b = on && i1 < P ? rows[(long long)k * P + i1] : 0.f;
      x[k] = a + b;
    }
#pragma unroll
    for (int s = 16; s > 0; s >>= 1)
#pragma unroll
      for (int k = 0; k < kSums; ++k) x[k] += __shfl_down_sync(0xffffffffu, x[k], s);
    if (lane == 0)
#pragma unroll
      for (int k = 0; k < kSums; ++k) part[warp][k] = x[k];
    __syncthreads();
    if (threadIdx.x < kSums)  // sum k on thread k, the blocks in order
      for (int w = 0; w < warps && b0 + w < nb; ++w) sum_k += part[w][threadIdx.x];
    __syncthreads();
  }
  if (threadIdx.x < kSums) total[threadIdx.x] = sum_k;
  __syncthreads();
  for (int k = 0; k < kSums; ++k) acc[k] = total[k];
}

// `iterations` IRLS rounds (kLoop: from p.delta, icp_match) or one round on
// the given moved points (icp_iteration), in one launch on one cluster.
// Per round: every CTA's groups find their points' nearest targets and
// write their 13 values to the round's half of p.rows; a cluster barrier;
// every CTA sums the rows and runs the GN update on its own copy of delta
// (all alike), CTA 0 also into p.delta, p.out and p.ctrl.
template <bool kLoop>
__global__ void __launch_bounds__(kLoopThreads) k_icp_rounds(IcpProblem p, int iterations,
                                                            int early_exit) {
  __shared__ float4 st[kLoopTile];
  __shared__ float sc[3 * kLoopTile];
  __shared__ float sdelta[3];
  __shared__ float sout[kLanes];
  __shared__ int sdone;
  const int t = threadIdx.x, g = t % kGroup, slot = t / kGroup;
  const bool whole = p.Q <= kLoopTile;
  const bool lead = blockIdx.x == 0 && t == 0;
  if (t == 0) {
    for (int k = 0; k < 3; ++k) sdelta[k] = kLoop ? p.delta[k] : 0.f;
    sdone = 0;
  }
  if (kLoop && lead) {
    p.ctrl[0] = 0;
    p.ctrl[1] = 0;
  }
  if (whole) stage_tile(p.tgt, p.tgt_valid, 0, p.Q, st, CovStager{p, sc});
  __syncthreads();
  const int per_cta = (p.P + gridDim.x - 1) / gridDim.x;
  const int passes = (per_cta + kGroupsPerCta - 1) / kGroupsPerCta;
  for (int it = 0; it < iterations; ++it) {
    float* rows = p.rows + (long long)(it & 1) * kSums * p.P;
    const float d0 = sdelta[0], d1 = sdelta[1], d2 = sdelta[2];
    for (int ps = 0; ps < passes; ++ps) {
      const int local = ps * kGroupsPerCta + slot;
      const long long n = (long long)blockIdx.x * per_cta + local;
      const bool live = local < per_cta && n < p.P;
      const int i = live ? (int)n : 0;
      RoundIn in{0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
      if (live) in = round_in<kLoop>(p, i, d0, d1, d2);
      const Nearest nn = group_nearest<kGroup>(p.tgt, p.tgt_valid, p.Q, kBigIcp, live, in.mx,
                                               in.my, g, whole, st, CovStager{p, sc});
      if (live && g == 0) {
        const int q = nn.idx;
        const Sums v = whole
            ? point_sums(p, i, in, nn.d2, st[q].x, st[q].y, sc[3 * q], sc[3 * q + 1],
                         sc[3 * q + 2])
            : point_sums(p, i, in, nn.d2, p.tgt[2 * q], p.tgt[2 * q + 1], p.ct[3 * q],
                         p.ct[3 * q + 1], p.ct[3 * q + 2]);
        for (int k = 0; k < kSums; ++k) rows[(long long)k * p.P + i] = v.v[k];
      }
    }
    stage_sync();
    float acc[kSums];
    rows_sum(rows, p.P, acc);
    if (t == 0) {
      if (kLoop) {
        const float norm = icp_update(acc, sdelta, blockIdx.x == 0 ? p.out : sout);
        // while_loop's cond is (k < iterations) & (|upd| >= tol): a NaN stops it.
        sdone = early_exit && !(norm >= p.tol);
        if (blockIdx.x == 0) {
          for (int k = 0; k < 3; ++k) p.delta[k] = sdelta[k];
          p.ctrl[1] = it + 1;
          p.ctrl[0] = sdone;
        }
      } else if (blockIdx.x == 0) {
        for (int k = 0; k < kLanes; ++k) p.out[k] = k < kSums ? acc[k] : 0.f;
      }
    }
    __syncthreads();
    if (sdone) break;  // the same on every CTA
  }
}

// K8: index and squared distance of the nearest valid target (invalid ones
// reading +inf), a group of G threads a source point on CTAs of blockDim.x
// threads (a multiple of 32): group_nearest over the targets staged tile by
// tile. No reduction across points, so no cluster: a plain grid of
// ceil(P / (blockDim.x / G)) CTAs.
template <int G>
__global__ void __launch_bounds__(1024) k_nn(const float* src, const float* tgt,
                                             const unsigned char* valid, int* idx, float* d2,
                                             int P, int Q) {
  __shared__ float4 st[kLoopTile];
  const int g = threadIdx.x % G;
  const long long i = (long long)blockIdx.x * (blockDim.x / G) + threadIdx.x / G;
  const bool live = i < P;
  const float mx = live ? src[2 * i] : 0.f, my = live ? src[2 * i + 1] : 0.f;
  const Nearest nn = group_nearest<G>(tgt, valid, Q, INFINITY, live, mx, my, g, false, st,
                                      [](int, int) {});
  if (live && g == 0) {
    idx[i] = nn.idx;
    d2[i] = nn.d2;
  }
}

// K8's launch shape: a group of kNnGroup threads a source point on CTAs of
// kNnThreads (scripts/bench_persistent.py part k8; PERF.md).
constexpr int kNnGroup = 16;
constexpr int kNnThreads = 256;

// The serial yardstick: one thread a point scanning every target
// (block_nearest), 64-point blocks.
__global__ void k_nn_serial(const float* src, const float* tgt, const unsigned char* valid,
                            int* idx, float* d2, int P, int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < P;
  const Nearest nn = block_nearest(live ? src[2 * i] : 0.f, live ? src[2 * i + 1] : 0.f, tgt,
                                   valid, Q, INFINITY);
  if (live) {
    idx[i] = nn.idx;
    d2[i] = nn.d2;
  }
}

#define ICP_CHECK()                                 \
  do {                                              \
    const cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

// The persistent launch over P points: one cluster of loop_ctas(P) CTAs.
template <bool kLoop>
int launch_rounds(const IcpProblem& p, int iterations, int early_exit) {
  return (int)launch_persistent(k_icp_rounds<kLoop>, Shape{loop_ctas(p.P), false},
                                kLoopThreads, (cudaStream_t)p.stream, p, iterations, early_exit);
}

}  // namespace

extern "C" {

const char* icp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of the staged shape's partials buffer for P source points.
int icp_partials_floats(int P) { return point_blocks(P) * kLanes; }

// Floats of the persistent shape's row buffer for P source points.
long long icp_rows_floats(int P) { return 2LL * kSums * P; }

// CTAs of the persistent launch over P source points (one cluster), and
// the targets its CTAs hold in shared memory at once.
int icp_ctas(int P) { return loop_ctas(P); }

int icp_loop_tile() { return kLoopTile; }

// K2, one round on moved points, jtheta and rotated covs: out[0:13] = the
// sums. One launch of k_icp_rounds<false>.
int icp_iteration(const IcpProblem* pp) { return launch_rounds<false>(*pp, 1, 0); }

// icp_iteration as the staged shape: k_icp_iter, then k_icp_finish.
int icp_iteration_staged(const IcpProblem* pp) {
  const IcpProblem& p = *pp;
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int nb = point_blocks(p.P);
  k_icp_iter<false><<<nb, kBlock, 0, s>>>(p, 0);
  ICP_CHECK();
  k_icp_finish<false><<<1, 1, 0, s>>>(p, nb, 0);
  ICP_CHECK();
  return 0;
}

// The IRLS loop: `iterations` rounds from p.delta, one launch of
// k_icp_rounds<true>, no host synchronization.
int icp_match(const IcpProblem* pp, int iterations, int early_exit) {
  if (iterations < 1) return (int)cudaErrorInvalidValue;
  return launch_rounds<true>(*pp, iterations, early_exit);
}

// icp_match as the staged shape: `iterations` rounds of k_icp_iter and
// k_icp_finish, those after convergence returning at once.
int icp_match_staged(const IcpProblem* pp, int iterations, int early_exit) {
  const IcpProblem& p = *pp;
  if (iterations < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int nb = point_blocks(p.P);
  if (cudaMemsetAsync(p.ctrl, 0, 2 * sizeof(int), s) != cudaSuccess)
    return (int)cudaGetLastError();
  for (int it = 0; it < iterations; ++it) {
    k_icp_iter<true><<<nb, kBlock, 0, s>>>(p, early_exit);
    ICP_CHECK();
    k_icp_finish<true><<<1, 1, 0, s>>>(p, nb, early_exit);
    ICP_CHECK();
  }
  return 0;
}

// K8 on (P, 2) sources and (Q, 2) targets: one launch of k_nn<kNnGroup> on
// CTAs of kNnThreads.
int nn_search(const float* src, const float* tgt, const unsigned char* valid, int* idx,
              float* d2, int P, int Q, void* stream) {
  if (P < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  constexpr int per_cta = kNnThreads / kNnGroup;
  k_nn<kNnGroup><<<(P + per_cta - 1) / per_cta, kNnThreads, 0, s>>>(src, tgt, valid, idx, d2,
                                                                     P, Q);
  ICP_CHECK();
  return 0;
}

// K8 as one thread a point (k_nn_serial): the shape nn_search replaced,
// bitwise equal to it; a yardstick for checks and timings, never on the
// path.
int nn_search_serial(const float* src, const float* tgt, const unsigned char* valid, int* idx,
                     float* d2, int P, int Q, void* stream) {
  if (P < 1 || Q < 1) return (int)cudaErrorInvalidValue;
  const cudaStream_t s = (cudaStream_t)stream;
  k_nn_serial<<<point_blocks(P), kBlock, 0, s>>>(src, tgt, valid, idx, d2, P, Q);
  ICP_CHECK();
  return 0;
}

}  // extern "C"
