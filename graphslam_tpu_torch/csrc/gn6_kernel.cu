// Fused SE(3) Gauss-Newton and Levenberg-Marquardt for Hopper (sm_90a): the
// CUDA port of the Pallas kernels graphslam_tpu/ops/gn6_kernel.py::_gn6_kernel
// (K4, GN and LM modes) and graphslam_tpu/ops/pcg6_kernel.py::_kernel6 (K5).
//
// K1 (gn_kernel.cu) with 6x6 blocks and SE(3) poses. One GN iteration is a
// fixed sequence of row stages:
//
//   linearize       one thread per chain/loop edge: between, SO(3) log,
//                   Jr^-1 (with Barfoot's Q), Ad(h^-1), whitening, Huber on
//                   loop edges when huber_delta > 0 (gn6_kernel.py:548-574);
//                   then Aii, Aij, Ajj, gi, gj (Aij kept for H@v)
//   assemble        one thread per node: D and g from its chain neighbours,
//                   its prior and its incident loop edges (a CSR in edge
//                   order, masked edges left out: fixed order, no atomics);
//                   in LM mode D's 6 diagonal entries are scaled by (1 + lam)
//   PCR factor      one stage per PCR level; ridge eps/6 |tr| + 1e-8, the
//                   6x6 inverse as the Schur complement of the lower-right
//                   3x3 over the 3x3 adjugate inverse (gn6_kernel.py:127-149)
//   CG, cg_iters times:
//     H@p           with the partial sums of p.Ap per 256-row block
//     update        alpha from the partials (same order everywhere)
//     PCR apply     one stage per level; the last applies Dinv and adds
//                   the partial sums of r.z
//     direction     beta, p = z + beta p, rz kept on the device
//   retract         x <- x * Exp(dx), then one polar-Newton step on R
//                   (gn6_kernel.py:529-535, 877-882)
//
// An LM iteration (gn6_kernel.py:917-946) adds the candidate's cost (block
// partials), the decision (one thread: accept or reject, the lambda
// schedule, the stats) and the select (poses <- candidate where accepted).
//
// Two launch shapes run these stages:
//
//   gn6_solve, gn6_lm_solve   ONE launch a solve of k6_gn_wide / k6_lm_wide
//       on CTAs of kWide (384) threads (se3_blocks.cuh's wide stages): the
//       PCR factor and apply levels, H@p and the CG vector stages give each
//       row a group of 6 threads, one per output component (row a of each
//       6x6 product, the 6x6 operands staged in shared memory, binv6 whole
//       in one thread of the group); linearize, assemble, retract and the
//       cost take one thread a row; a barrier where the staged sequence has
//       a kernel boundary, the LM decision on CTA 0 between two barriers.
//       The CTAs hold one pass over the rows (60 rows a CTA): one cluster
//       where that takes at most 16 CTAs (garage: 16), else a cooperative
//       grid (sphere2500: 42 CTAs) with a grid barrier (wide_shape).
//   gn6_solve_staged, gn6_lm_solve_staged   the staged sequence: one small
//       launch per stage (k6_*, one thread a row, n_blocks(N) blocks of
//       256) on the caller's stream, 404 an iteration at sphere2500 (K =
//       12, cg 25). The yardstick: the wide kernels give bitwise its poses,
//       x and stats.
//
// What bounds it: at sphere2500 size (2500 poses, 2450 loop edges) every
// array is a few MB and sits in the 50 MB L2; neither bytes nor FLOPs bound
// it but the latency of 404 dependent stages an iteration. Staged, each
// stage was a launch on 10 blocks of one register-heavy thread a row
// (k6_pcr_factor ~200 registers for two 6x6 inverses and four products);
// the wide kernels trade the launches for barriers and spread each heavy
// row over 6 threads. Measured on the card (PERF.md; scripts/
// bench_persistent.py times the other shape): a stage costs about as much
// per pass over the rows as the pass's width saves, so one pass of a grid
// beats a cluster walking three; a cluster barrier costs less than a grid
// barrier at the same CTA count, so the cluster wins where 16 CTAs hold
// the pass.
//
// K5 (gn6_pcg) is the PCR factor at the exact K = ceil(log2 N) and a cold CG
// on a D, U, b and loop blocks that the caller supplies (damped in torch
// beforehand, as the JAX package damps in XLA): ONE launch of k6_pcg_wide,
// K4's wide factor and CG stages in K4's shape (garage: one 16-CTA
// cluster); gn6_factor + gn6_cg, the staged kernels (347 launches at
// garage), are its yardstick, bitwise equal.
//
// The SO(3) log calls acosf in its generic branch, as geometry/so3.py's log
// does; the TPU kernel's _acos_no_trig (gn6_kernel.py:321) only works around
// Mosaic. Every reduction has a fixed order, so two runs on one card give
// bitwise equal poses.
//
// The 6x6, SO(3)/SE(3) and PCR device code sits in se3_blocks.cuh, shared
// with csrc/cg_step6.cu (K7a-c).
//
// Line references "gn6_kernel.py:N" are to graphslam_tpu/ops/gn6_kernel.py.
//
// Plain C interface for ctypes: every function takes a Gn6Problem* whose
// pointers are device pointers, launches on problem->stream and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "se3_blocks.cuh"

extern "C" {

struct Gn6Problem {
  float* poses;        // (N, 12) in/out: row-major R (9), then t (3)
  const float* cz;     // (c, 12) chain measurements, identity where masked
  const float* cW;     // (c, 36) chain sqrt-information, zero where masked
  const float* pz;     // (N, 12) per-node prior measurement (identity: none)
  const float* pW;     // (N, 36) per-node prior sqrt-information (zero: none)
  const int* li;       // (El,) loop edge endpoints
  const int* lj;
  const float* lz;     // (El, 12)
  const float* lW;     // (El, 36)
  const int* csr_ptr;  // (N+1,)
  const int* csr_ent;  // 2*l + side, ascending l per node, live edges only
  float* D;            // (N, 36) assembled diagonal blocks
  float* U;            // (N, 36) chain blocks, U[n] couples n and n+1
  float* b;            // (N, 6) right-hand side -g
  float* x;            // (N, 6) CG solution (and warm-start seed)
  float* ws;           // workspace of gn6_ws_floats(...) floats
  const float* lA;     // (El, 36) loop blocks from the caller (K5), or null:
                       // K4's own, linearized into the workspace
  float* stats;        // (4,) LM state [chi2, lam, n_acc, conv], or null (GN)
  void* stream;        // cudaStream_t
  int N, c, El, K, cg_max;
  float eps, huber_delta;
};

}  // extern "C"

namespace {

// Workspace carve-up (floats).
struct Ws {
  float* Aij;       // (c+El, 36)
  float* blk;       // (c+El, 84): Aii 36, Ajj 36, gi 6, gj 6
  float* PD[2];     // PCR working blocks, ping-pong (N, 36)
  float* PU[2];
  float* PL[2];
  float* A;         // (K, N, 36) PCR coefficients alpha
  float* G;         // (K, N, 36) PCR coefficients gamma
  float* DinvF;     // (N, 36)
  float* r;         // (N, 6) CG vectors
  float* z;
  float* p;
  float* Ap;
  float* t[2];      // PCR apply ping-pong
  float* part_a;    // (n_blocks(N),) partial sums of p.Ap
  float* part_b;    // (n_blocks(N),) partial sums of r.z
  float* rz;        // (cg_max + 1,) r.z per CG iteration
  float* cand;      // (N, 12) LM candidate poses
  float* part_e;    // (n_blocks(c + El + N),) partial sums of the cost
  float* acc;       // (1,) LM: 1 where the last step was accepted
  float* va;        // (N,) row values of p.Ap (the wide kernels' reductions)
  float* vb;        // (N,) row values of r.z
  float* ve;        // (c + El + N,) row values of the cost
  long long total;
};

Ws layout(int N, int c, int El, int K, int cg_max, float* base) {
  Ws w;
  long long off = 0;
  auto take = [&](long long n) {
    float* ptr = base ? base + off : nullptr;
    off += n;
    return ptr;
  };
  const long long E = (long long)c + El;
  const long long N36 = 36LL * N, N6 = 6LL * N;
  w.Aij = take(36 * E);
  w.blk = take(84 * E);
  for (int i = 0; i < 2; ++i) {
    w.PD[i] = take(N36);
    w.PU[i] = take(N36);
    w.PL[i] = take(N36);
  }
  w.A = take(N36 * K);
  w.G = take(N36 * K);
  w.DinvF = take(N36);
  w.r = take(N6);
  w.z = take(N6);
  w.p = take(N6);
  w.Ap = take(N6);
  w.t[0] = take(N6);
  w.t[1] = take(N6);
  w.part_a = take(n_blocks(N));
  w.part_b = take(n_blocks(N));
  w.rz = take(cg_max + 1);
  w.cand = take(12LL * N);
  w.part_e = take(n_blocks(E + N));
  w.acc = take(1);
  w.va = take(N);
  w.vb = take(N);
  w.ve = take(E + N);
  w.total = off;
  return w;
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// The one-thread row functions below are __noinline__: the staged kernels
// and the wide ones call one compiled body, so the two launch shapes round
// alike (inlined into kernels of other register budgets, nvcc contracted
// the same source to FMAs differently: Aij differed by 1.22e-4 at garage,
// NVIDIA H100 80GB HBM3).

// Edge row e < c + El: chain edge e or loop edge e - c, linearized at the
// poses; Aij into w.Aij, Aii, Ajj, gi, gj into w.blk.
__device__ __noinline__ void linearize_row6(const Gn6Problem& p, const Ws& w, int e) {
  Pose xi, xj, z;
  M6 W;
  float huber = -1.f;
  if (e < p.c) {
    xi = ld_pose(p.poses, e);
    xj = ld_pose(p.poses, e + 1);
    z = ld_pose(p.cz, e);
    W = ld36(p.cW, e);
  } else {
    const int l = e - p.c;
    xi = ld_pose(p.poses, p.li[l]);
    xj = ld_pose(p.poses, p.lj[l]);
    z = ld_pose(p.lz, l);
    W = ld36(p.lW, l);
    huber = p.huber_delta;
  }
  V6 rw;
  M6 Jiw, Jjw;
  linearize_edge(xi, xj, z, W, huber, rw, Jiw, Jjw);
  st36(w.Aij, e, m6Tmul(Jiw, Jjw));
  float* out = w.blk + 84LL * e;
  st36(out, 0, m6Tmul(Jiw, Jiw));
  st36(out + 36, 0, m6Tmul(Jjw, Jjw));
  st6(out + 72, 0, m6Tvec(Jiw, rw));
  st6(out + 78, 0, m6Tvec(Jjw, rw));
}

__global__ void __launch_bounds__(kThreads) k6_linearize(Gn6Problem p, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.c + p.El) return;
  linearize_row6(p, w, e);
}

// Node row n: D, b and U from its chain edges, its prior and its loop edges
// in CSR order; in LM mode D's diagonal times (1 + lam).
__device__ __noinline__ void assemble_row6(const Gn6Problem& p, const Ws& w, int n) {
  M6 D = m6zero();
  V6 g = v6zero();
  if (n < p.c) {  // chain edge n = (n, n+1): node n is its i end
    const float* e = w.blk + 84LL * n;
    m6add(D, ld36(e, 0));
    v6add(g, ld6(e + 72, 0));
  }
  if (n >= 1 && n - 1 < p.c) {  // chain edge n-1: node n is its j end
    const float* e = w.blk + 84LL * (n - 1);
    m6add(D, ld36(e + 36, 0));
    v6add(g, ld6(e + 78, 0));
  }
  {  // prior: r = Log(z^-1 x), J = Jr^{-1}(r), zero sqrt-info = no prior
    const V6 rp = se3_log(se3_between(ld_pose(p.pz, n), ld_pose(p.poses, n)));
    const M6 pW = ld36(p.pW, n);
    const M6 Jpw = m6mul(pW, se3_jr_inv(rp));
    m6add(D, m6Tmul(Jpw, Jpw));
    v6add(g, m6Tvec(Jpw, m6vec(pW, rp)));
  }
  for (int q = p.csr_ptr[n]; q < p.csr_ptr[n + 1]; ++q) {
    const int ent = p.csr_ent[q];
    const float* e = w.blk + 84LL * (p.c + (ent >> 1));
    if (ent & 1) {
      m6add(D, ld36(e + 36, 0));
      v6add(g, ld6(e + 78, 0));
    } else {
      m6add(D, ld36(e, 0));
      v6add(g, ld6(e + 72, 0));
    }
  }
  if (p.stats) {  // LM: Marquardt damping D_ii * (1 + lam) (gn6_kernel.py:780-786)
    const float s = 1.f + p.stats[1];
#pragma unroll
    for (int i = 0; i < 6; ++i) D.m[7 * i] *= s;
  }
  st36(p.D, n, D);
#pragma unroll
  for (int i = 0; i < 6; ++i) g.v[i] = -g.v[i];
  st6(p.b, n, g);
  st36(p.U, n, n < p.c ? ld36(w.Aij, n) : m6zero());
}

__global__ void __launch_bounds__(kThreads) k6_assemble(Gn6Problem p, Ws w) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  assemble_row6(p, w, n);
}

// One PCR level (pcr6_factor_row in se3_blocks.cuh); the last level writes
// the final inverse instead of D', L', U'.
__global__ void __launch_bounds__(kThreads) k6_pcr_factor(
    Gn6Problem p, Ws w, int k, const float* Ds, const float* Us, const float* Ls, float* Dd,
    float* Ud, float* Ld, int last) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  pcr6_factor_row(n, p.N, k, p.eps, Ds, Us, Ls, p.U, w.A, w.G, w.DinvF, Dd, Ud, Ld, last);
}

// One PCR apply level (pcr6_apply_row); the last level also applies Dinv
// and, with rdot, adds the partial sums of rdot.out per block to part.
__global__ void __launch_bounds__(kThreads) k6_pcr_apply(
    Gn6Problem p, Ws w, int k, const float* in, float* out, int last, const float* rdot,
    float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float val = 0.f;
  if (n < p.N) {
    const V6 o = pcr6_apply_row(n, p.N, k, w.A, w.G, w.DinvF, in, out, last);
    if (rdot) val = v6dot(ld6(rdot, n), o);
  }
  if (part) block_sum_to(val, part, blockIdx.x);
}

// out = H v: diagonal blocks, chain U and L = U^T of the previous node,
// then the node's loop edges in CSR order. With part, adds the partial sums
// of v.out per block.
__global__ void __launch_bounds__(kThreads) k6_hvp(Gn6Problem p, Ws w, const float* v,
                                                   float* out, float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float val = 0.f;
  if (n < p.N) {
    const V6 vn = ld6(v, n);
    V6 o = m6vec(ld36(p.D, n), vn);
    if (n + 1 < p.N) v6add(o, m6vec(ld36(p.U, n), ld6(v, n + 1)));
    if (n >= 1) v6add(o, m6Tvec(ld36(p.U, n - 1), ld6(v, n - 1)));
    const float* LA = p.lA ? p.lA : w.Aij + 36LL * p.c;
    for (int q = p.csr_ptr[n]; q < p.csr_ptr[n + 1]; ++q) {
      const int ent = p.csr_ent[q];
      const int l = ent >> 1;
      const M6 A = ld36(LA, l);
      if (ent & 1) v6add(o, m6Tvec(A, ld6(v, p.li[l])));  // node is j: A^T v_i
      else v6add(o, m6vec(A, ld6(v, p.lj[l])));           // node is i: A v_j
    }
    st6(out, n, o);
    if (part) val = v6dot(vn, o);
  }
  if (part) block_sum_to(val, part, blockIdx.x);
}

// Component a of k6_hvp's row n (live) on the row's group: out[n][a] =
// (H v)[n][a], each block's product summed in m6vec's / m6Tvec's order. With
// vals, the group's thread 0 writes v[n].out[n] to vals[n].
__device__ __forceinline__ void hvp6_lane(const Gn6Problem& p, const Ws& w, const float* v,
                                          float* out, float* vals, int n, int a, bool live,
                                          float* S) {
  float o = 0.f;
  if (live) {
    const float* vn = v + 6LL * n;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) s += p.D[36LL * n + 6 * a + q] * vn[q];
    o = s;
    if (n + 1 < p.N) {
      s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += p.U[36LL * n + 6 * a + q] * v[6LL * (n + 1) + q];
      o += s;
    }
    if (n >= 1) {
      s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += p.U[36LL * (n - 1) + 6 * q + a] * v[6LL * (n - 1) + q];
      o += s;
    }
    const float* LA = p.lA ? p.lA : w.Aij + 36LL * p.c;
    for (int e = p.csr_ptr[n]; e < p.csr_ptr[n + 1]; ++e) {
      const int ent = p.csr_ent[e];
      const int l = ent >> 1;
      const float* A = LA + 36LL * l;
      s = 0.f;
      if (ent & 1) {  // node is j: A^T v_i
        const float* vi = v + 6LL * p.li[l];
#pragma unroll
        for (int q = 0; q < 6; ++q) s += A[6 * q + a] * vi[q];
      } else {        // node is i: A v_j
        const float* vj = v + 6LL * p.lj[l];
#pragma unroll
        for (int q = 0; q < 6; ++q) s += A[6 * a + q] * vj[q];
      }
      o += s;
    }
    out[6LL * n + a] = o;
  }
  if (vals) {
    if (live) S[a] = o;
    __syncwarp();
    if (live && a == 0) {
      float d = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) d += v[6LL * n + q] * S[q];
      vals[n] = d;
    }
    __syncwarp();
  }
}

// Start of CG: cold x = 0, r = b; warm r = b - H x (Ap holds H x).
__global__ void __launch_bounds__(kThreads) k6_cg_init(Gn6Problem p, Ws w, int warm) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  V6 r = ld6(p.b, n);
  if (warm) {
    const V6 hx = ld6(w.Ap, n);
#pragma unroll
    for (int a = 0; a < 6; ++a) r.v[a] -= hx.v[a];
  } else {
    st6(p.x, n, v6zero());
  }
  st6(w.r, n, r);
}

// alpha = rz / pAp, guarded (the same in every block: the partials are
// summed in block order).
__device__ __forceinline__ float cg_alpha6(float pAp, float rz) {
  return pAp > kTiny ? rz / fmaxf(pAp, kTiny) : 0.f;
}

// beta = rz_new / rz, guarded.
__device__ __forceinline__ float cg_beta6(float rz_new, float rz) {
  return rz > kTiny ? rz_new / fmaxf(rz, kTiny) : 0.f;
}

// x += alpha p; r -= alpha Ap.
__global__ void __launch_bounds__(kThreads) k6_cg_update(Gn6Problem p, Ws w, int it) {
  const float alpha = cg_alpha6(sum_partials(w.part_a, n_blocks(p.N)), w.rz[it]);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  V6 x = ld6(p.x, n), r = ld6(w.r, n);
  const V6 pv = ld6(w.p, n), ap = ld6(w.Ap, n);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    x.v[a] += alpha * pv.v[a];
    r.v[a] -= alpha * ap.v[a];
  }
  st6(p.x, n, x);
  st6(w.r, n, r);
}

// rz_new from the partials; p = z (init) or z + beta p; rz[it+1] = rz_new.
__global__ void __launch_bounds__(kThreads) k6_cg_direction(Gn6Problem p, Ws w, int it,
                                                            int init) {
  const float rz_new = sum_partials(w.part_b, n_blocks(p.N));
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const float beta = init ? 0.f : cg_beta6(rz_new, w.rz[it]);
  if (blockIdx.x == 0 && threadIdx.x == 0) w.rz[init ? 0 : it + 1] = rz_new;
  if (n >= p.N) return;
  const V6 z = ld6(w.z, n);
  if (init) {
    st6(w.p, n, z);
    return;
  }
  V6 pv = ld6(w.p, n);
#pragma unroll
  for (int a = 0; a < 6; ++a) pv.v[a] = z.v[a] + beta * pv.v[a];
  st6(w.p, n, pv);
}

// out = poses * Exp(x) at row n with R renormalized; out may be poses itself
// (each thread owns its node).
__device__ __noinline__ void retract_row6(const Gn6Problem& p, float* out, int n) {
  Pose q = se3_compose(ld_pose(p.poses, n), se3_exp(ld6(p.x, n)));
  q.R = renorm(q.R);
  st_pose(out, n, q);
}

__global__ void __launch_bounds__(kThreads) k6_retract(Gn6Problem p, float* out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  retract_row6(p, out, n);
}

// Cost of `poses` (gn6_kernel.py:687-714): squares on chain and prior rows,
// Huber rho = 2 delta n - delta^2 (n = |rw|, where n > delta) on every loop
// edge when delta > 0. Row t takes chain edge t (t < c), loop edge t - c
// (t < c + El) or the prior of node t - c - El; 0 past them.
__device__ __noinline__ float chi2_row6(const Gn6Problem& p, const float* poses, int t) {
  float e = 0.f;
  if (t < p.c) {
    const V6 rw = residual_edge(ld_pose(poses, t), ld_pose(poses, t + 1), ld_pose(p.cz, t),
                                ld36(p.cW, t));
    e = v6dot(rw, rw);
  } else if (t < p.c + p.El) {
    const int l = t - p.c;
    const V6 rw = residual_edge(ld_pose(poses, p.li[l]), ld_pose(poses, p.lj[l]),
                                ld_pose(p.lz, l), ld36(p.lW, l));
    e = v6dot(rw, rw);
    if (p.huber_delta > 0.f) {
      const float nrm = sqrtf(fmaxf(e, 1e-24f));
      if (!(nrm <= p.huber_delta)) e = 2.f * p.huber_delta * nrm - p.huber_delta * p.huber_delta;
    }
  } else if (t < p.c + p.El + p.N) {
    const int n = t - p.c - p.El;
    const V6 rp = m6vec(ld36(p.pW, n), se3_log(se3_between(ld_pose(p.pz, n), ld_pose(poses, n))));
    e = v6dot(rp, rp);
  }
  return e;
}

// The per-block partials of the cost go to w.part_e and are summed in block
// order by k6_lm_decide / k6_cost_total.
__global__ void __launch_bounds__(kThreads) k6_chi2(Gn6Problem p, Ws w, const float* poses) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  block_sum_to(chi2_row6(p, poses, t), w.part_e, blockIdx.x);
}

__device__ __forceinline__ float cost_total(const Gn6Problem& p, const Ws& w) {
  float acc = 0.f;
  const int nb = n_blocks((long long)p.c + p.El + p.N);
  for (int i = 0; i < nb; ++i) acc += w.part_e[i];
  return acc;
}

// One thread: the cost from k6_chi2's partials into out[0].
__global__ void k6_cost_total(Gn6Problem p, Ws w, float* out) { out[0] = cost_total(p, w); }

struct LmParams {
  float lam0, lam_factor, lam_min, lam_max, abs_tol, rel_tol;
};

// One thread: stats = [cost of poses0, lam0, 0, 0].
__device__ __forceinline__ void lm_init6(const Gn6Problem& p, const LmParams& q, float cost) {
  p.stats[0] = cost;
  p.stats[1] = q.lam0;
  p.stats[2] = 0.f;
  p.stats[3] = 0.f;
}

__global__ void k6_lm_init(Gn6Problem p, Ws w, LmParams q) { lm_init6(p, q, cost_total(p, w)); }

// One thread: accept or reject the candidate of cost new_err
// (gn6_kernel.py:920-946). A NaN cost rejects; conv latches the _lm_loop
// test with lam before its update.
__device__ __forceinline__ void lm_decide6(const Gn6Problem& p, const Ws& w, const LmParams& q,
                                           float new_err) {
  const float err = p.stats[0], lam = p.stats[1];
  const bool accepted = new_err < err;
  const float dec = err - new_err;
  const bool conv = p.stats[3] != 0.f ||
                    (accepted && (dec < q.abs_tol || dec < q.rel_tol * err)) ||
                    lam >= q.lam_max;
  p.stats[0] = accepted ? new_err : err;
  p.stats[1] = accepted ? fmaxf(lam / q.lam_factor, q.lam_min)
                        : fminf(lam * q.lam_factor, q.lam_max);
  p.stats[2] += accepted ? 1.f : 0.f;
  p.stats[3] = conv ? 1.f : 0.f;
  w.acc[0] = accepted ? 1.f : 0.f;
}

__global__ void k6_lm_decide(Gn6Problem p, Ws w, LmParams q) {
  lm_decide6(p, w, q, cost_total(p, w));
}

// Row n: poses <- candidate where the last step was accepted.
__device__ __forceinline__ void lm_select_row6(const Gn6Problem& p, const Ws& w, int n) {
  if (w.acc[0] != 0.f) st_pose(p.poses, n, ld_pose(w.cand, n));
}

__global__ void __launch_bounds__(kThreads) k6_lm_select(Gn6Problem p, Ws w) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  lm_select_row6(p, w, n);
}

// ---------------------------------------------------------------------------
// Wide persistent kernels: K4 and K4-LM, each ONE launch of kWide-thread
// CTAs, one cluster or a cooperative grid (se3_blocks.cuh's wide stages)
// ---------------------------------------------------------------------------

// run_system's two stages: the E edge rows, then the N node rows, one
// thread a row.
__device__ __forceinline__ void system6_stages(const Gn6Problem& p, const Ws& w) {
  for_flat(p.c + p.El, [&](int e) { linearize_row6(p, w, e); });
  stage_sync();
  for_flat(p.N, [&](int n) { assemble_row6(p, w, n); });
  stage_sync();
}

// run_cg's stages on the row groups: with warm, H x first; the init, the
// first K apply levels and the direction, then cg_iters x (H@p, update, K
// apply levels, direction). The last direction has no barrier after it.
__device__ __forceinline__ void cg6_stages(const Gn6Problem& p, const Ws& w, int cg_iters,
                                           int warm) {
  const int N = p.N, K = p.K;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  if (warm) {
    for_groups(N, [&](int n, int a, bool live, float* S) {
      hvp6_lane(p, w, p.x, w.Ap, nullptr, n, a, live, S);
    });
    stage_sync();
  }
  for_groups(N, [&](int n, int a, bool live, float*) {
    if (!live) return;
    float r = p.b[6LL * n + a];
    if (warm) r -= w.Ap[6LL * n + a];
    else p.x[6LL * n + a] = 0.f;
    w.r[6LL * n + a] = r;
  });
  stage_sync();
  apply6_stages(N, K, w.A, w.G, w.DinvF, w.r, w.t[0], w.t[1], w.z, w.r, w.vb);
  float rz_new = wide_sum(w.vb, N);
  if (lead) w.rz[0] = rz_new;
  for_groups(N, [&](int n, int a, bool live, float*) {
    if (live) w.p[6LL * n + a] = w.z[6LL * n + a];
  });
  for (int it = 0; it < cg_iters; ++it) {
    stage_sync();
    for_groups(N, [&](int n, int a, bool live, float* S) {
      hvp6_lane(p, w, w.p, w.Ap, w.va, n, a, live, S);
    });
    stage_sync();
    const float alpha = cg_alpha6(wide_sum(w.va, N), w.rz[it]);
    for_groups(N, [&](int n, int a, bool live, float*) {
      if (!live) return;
      const long long i = 6LL * n + a;
      p.x[i] += alpha * w.p[i];
      w.r[i] -= alpha * w.Ap[i];
    });
    stage_sync();
    apply6_stages(N, K, w.A, w.G, w.DinvF, w.r, w.t[0], w.t[1], w.z, w.r, w.vb);
    rz_new = wide_sum(w.vb, N);
    const float beta = cg_beta6(rz_new, w.rz[it]);
    if (lead) w.rz[it + 1] = rz_new;
    for_groups(N, [&](int n, int a, bool live, float*) {
      if (!live) return;
      const long long i = 6LL * n + a;
      w.p[i] = w.z[i] + beta * w.p[i];
    });
  }
}

// One GN iteration's stages after the system: the K factor levels and the
// CG.
__device__ __forceinline__ void solve6_stages(const Gn6Problem& p, const Ws& w, int cg_iters,
                                              int warm) {
  factor6_stages(p.N, p.K, p.eps, p.D, p.U, w.PD[0], w.PD[1], w.PU[0], w.PU[1], w.PL[0],
                 w.PL[1], w.A, w.G, w.DinvF);
  cg6_stages(p, w, cg_iters, warm);
}

// K4's GN mode: x = 0, then per GN iteration of each phase run_system,
// run_factor, run_cg and run_retract in place: 2 + K + (warm) + 2 + K +
// cg (K + 3) + 1 stages an iteration (404 at sphere2500: K = 12, cg 25).
__global__ void __launch_bounds__(kWide, 1) k6_gn_wide(Gn6Problem p, Ws w, Phases ph,
                                                       int warm) {
  for_flat(6LL * p.N, [&](int i) { p.x[i] = 0.f; });
  for (int f = 0; f < ph.n; ++f) {
    for (int i = 0; i < ph.iters[f]; ++i) {
      stage_sync();
      system6_stages(p, w);
      solve6_stages(p, w, ph.cg[f], warm);
      stage_sync();
      for_flat(p.N, [&](int n) { retract_row6(p, p.poses, n); });
    }
  }
}

// K5: the K factor levels on the caller's D and U, then a cold CG of
// cg_iters with the caller's loop blocks p.lA (hvp6_lane reads them as
// k6_hvp does): run_factor + run_cg(warm = 0), K + 1 + (K + 1) + cg (K + 3)
// stages (337 at garage: K = 10, cg 25).
__global__ void __launch_bounds__(kWide, 1) k6_pcg_wide(Gn6Problem p, Ws w, int cg_iters) {
  solve6_stages(p, w, cg_iters, 0);
}

// K4's LM mode: the cost of the poses and lm_init6, then per iteration the
// GN stages with a cold CG, the retract into the candidate, its cost (c +
// El + N rows), its sum and lm_decide6 on CTA 0 between two barriers, and
// the select.
__global__ void __launch_bounds__(kWide, 1) k6_lm_wide(Gn6Problem p, Ws w, LmParams q,
                                                       int iterations, int cg_iters) {
  const int T = p.c + p.El + p.N;
  for_flat(T, [&](int t) { w.ve[t] = chi2_row6(p, p.poses, t); });
  stage_sync();
  if (blockIdx.x == 0) {
    const float cost = wide_sum(w.ve, T);
    if (threadIdx.x == 0) lm_init6(p, q, cost);
  }
  for (int i = 0; i < iterations; ++i) {
    stage_sync();
    system6_stages(p, w);
    solve6_stages(p, w, cg_iters, 0);
    stage_sync();
    for_flat(p.N, [&](int n) { retract_row6(p, w.cand, n); });
    stage_sync();
    for_flat(T, [&](int t) { w.ve[t] = chi2_row6(p, w.cand, t); });
    stage_sync();
    if (blockIdx.x == 0) {
      const float cost = wide_sum(w.ve, T);
      if (threadIdx.x == 0) lm_decide6(p, w, q, cost);
    }
    stage_sync();
    for_flat(p.N, [&](int n) { lm_select_row6(p, w, n); });
  }
}

// ---------------------------------------------------------------------------
// Host side: launch sequences
// ---------------------------------------------------------------------------

#define GN_CHECK()                                  \
  do {                                              \
    const cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

#define GN_TRY(expr)              \
  do {                            \
    const int rc_ = (expr);       \
    if (rc_ != 0) return rc_;     \
  } while (0)

Ws ws_of(const Gn6Problem& p) { return layout(p.N, p.c, p.El, p.K, p.cg_max, p.ws); }

int run_system(const Gn6Problem& p, const Ws& w, cudaStream_t s) {
  const int E = p.c + p.El;
  if (E > 0) {
    k6_linearize<<<n_blocks(E), kThreads, 0, s>>>(p, w);
    GN_CHECK();
  }
  k6_assemble<<<n_blocks(p.N), kThreads, 0, s>>>(p, w);
  GN_CHECK();
  return 0;
}

int run_factor(const Gn6Problem& p, const Ws& w, cudaStream_t s) {
  for (int k = 0; k < p.K; ++k) {
    const int src = (k - 1) & 1, dst = k & 1;
    const float* Ds = k == 0 ? p.D : w.PD[src];
    const float* Us = k == 0 ? p.U : w.PU[src];
    const float* Ls = k == 0 ? nullptr : w.PL[src];
    k6_pcr_factor<<<n_blocks(p.N), kThreads, 0, s>>>(p, w, k, Ds, Us, Ls, w.PD[dst], w.PU[dst],
                                                    w.PL[dst], k == p.K - 1);
    GN_CHECK();
  }
  return 0;
}

int run_precond(const Gn6Problem& p, const Ws& w, const float* in, float* out,
                const float* rdot, float* part, cudaStream_t s) {
  const float* src = in;
  for (int k = 0; k < p.K; ++k) {
    const bool last = k == p.K - 1;
    float* dst = last ? out : w.t[k & 1];
    k6_pcr_apply<<<n_blocks(p.N), kThreads, 0, s>>>(p, w, k, src, dst, last,
                                                   last ? rdot : nullptr, last ? part : nullptr);
    GN_CHECK();
    src = dst;
  }
  return 0;
}

int run_cg(const Gn6Problem& p, const Ws& w, int cg_iters, int warm, cudaStream_t s) {
  const int nb = n_blocks(p.N);
  if (warm) {
    k6_hvp<<<nb, kThreads, 0, s>>>(p, w, p.x, w.Ap, nullptr);
    GN_CHECK();
  }
  k6_cg_init<<<nb, kThreads, 0, s>>>(p, w, warm);
  GN_CHECK();
  GN_TRY(run_precond(p, w, w.r, w.z, w.r, w.part_b, s));
  k6_cg_direction<<<nb, kThreads, 0, s>>>(p, w, 0, 1);
  GN_CHECK();
  for (int it = 0; it < cg_iters; ++it) {
    k6_hvp<<<nb, kThreads, 0, s>>>(p, w, w.p, w.Ap, w.part_a);
    GN_CHECK();
    k6_cg_update<<<nb, kThreads, 0, s>>>(p, w, it);
    GN_CHECK();
    GN_TRY(run_precond(p, w, w.r, w.z, w.r, w.part_b, s));
    k6_cg_direction<<<nb, kThreads, 0, s>>>(p, w, it, 0);
    GN_CHECK();
  }
  return 0;
}

int run_retract(const Gn6Problem& p, float* out, cudaStream_t s) {
  k6_retract<<<n_blocks(p.N), kThreads, 0, s>>>(p, out);
  GN_CHECK();
  return 0;
}

int run_chi2(const Gn6Problem& p, const Ws& w, const float* poses, cudaStream_t s) {
  k6_chi2<<<n_blocks((long long)p.c + p.El + p.N), kThreads, 0, s>>>(p, w, poses);
  GN_CHECK();
  return 0;
}

}  // namespace

extern "C" {

long long gn6_ws_floats(int N, int c, int El, int K, int cg_max) {
  return layout(N, c, El, K, cg_max, nullptr).total;
}

const char* gn6_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int gn6_problem_size() { return (int)sizeof(Gn6Problem); }

// The wide persistent kernels' shape: rows a CTA holds at once, and the
// CTAs of gn6_solve's launch over N rows, negative where they form a
// cooperative grid rather than one cluster (0: a CUDA error).
int gn6_wide_slots() { return kSlots; }

int gn6_wide_ctas(int N) {
  Shape sh;
  if (wide_shape(k6_gn_wide, N, sh) != cudaSuccess) return 0;
  return sh.cooperative ? -sh.ctas : sh.ctas;
}

int gn6_system(const Gn6Problem* p) {
  return run_system(*p, ws_of(*p), (cudaStream_t)p->stream);
}

int gn6_factor(const Gn6Problem* p) {
  return run_factor(*p, ws_of(*p), (cudaStream_t)p->stream);
}

int gn6_precond(const Gn6Problem* p, const float* in, float* out) {
  return run_precond(*p, ws_of(*p), in, out, nullptr, nullptr, (cudaStream_t)p->stream);
}

int gn6_cg(const Gn6Problem* p, int cg_iters, int warm) {
  if (cg_iters > p->cg_max) return (int)cudaErrorInvalidValue;
  return run_cg(*p, ws_of(*p), cg_iters, warm, (cudaStream_t)p->stream);
}

int gn6_retract(const Gn6Problem* p) {
  return run_retract(*p, p->poses, (cudaStream_t)p->stream);
}

// The cost of `poses` (N, 12) into out[0]: K4's LM cost pass on its own.
int gn6_chi2(const Gn6Problem* pp, const float* poses, float* out) {
  const Gn6Problem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  GN_TRY(run_chi2(p, w, poses, s));
  k6_cost_total<<<1, 1, 0, s>>>(p, w, out);
  GN_CHECK();
  return 0;
}

// K5: exact-K PCR factor and a cold CG of cg_iters on the caller's D, U, b
// and loop blocks p->lA; the solution lands in p->x. One launch of
// k6_pcg_wide in wide_shape's shape (garage: one 16-CTA cluster);
// gn6_factor then gn6_cg(cg_iters, 0) on the same problem is the same
// computation as a staged sequence of 2K + 2 + cg_iters (K + 3) launches
// (347 at garage), bitwise equal. No host synchronization.
int gn6_pcg(const Gn6Problem* pp, int cg_iters) {
  const Gn6Problem& p = *pp;
  if (cg_iters < 0 || cg_iters > p.cg_max) return (int)cudaErrorInvalidValue;
  Shape sh;
  const cudaError_t err = wide_shape(k6_pcg_wide, p.N, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(k6_pcg_wide, sh, kWide, (cudaStream_t)p.stream, p, ws_of(p),
                                cg_iters);
}

// K4's LM mode (gn6_kernel.py:917-955): `iterations` damped steps, each a
// cold CG of cg_iters, a candidate, its cost and the accept/reject; the
// stats [chi2, lam, n_acc, conv] stay in p->stats. One launch of
// k6_lm_wide (wide_shape: one cluster, or a cooperative grid where one
// pass over the rows needs more than 16 CTAs); gn6_lm_solve_staged is the
// same computation as a staged sequence of launches, bitwise equal. No host
// synchronization.
int gn6_lm_solve(const Gn6Problem* pp, int iterations, int cg_iters, float lam0,
                 float lam_factor, float lam_min, float lam_max, float abs_tol,
                 float rel_tol) {
  const Gn6Problem& p = *pp;
  if (cg_iters < 0 || cg_iters > p.cg_max || iterations < 0 || !p.stats || p.lA)
    return (int)cudaErrorInvalidValue;
  const LmParams q{lam0, lam_factor, lam_min, lam_max, abs_tol, rel_tol};
  Shape sh;
  const cudaError_t err = wide_shape(k6_lm_wide, p.N, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(k6_lm_wide, sh, kWide, (cudaStream_t)p.stream, p, ws_of(p), q,
                                iterations, cg_iters);
}

// gn6_lm_solve as the staged sequence of launches (its yardstick).
int gn6_lm_solve_staged(const Gn6Problem* pp, int iterations, int cg_iters, float lam0,
                        float lam_factor, float lam_min, float lam_max, float abs_tol,
                        float rel_tol) {
  const Gn6Problem& p = *pp;
  if (cg_iters < 0 || cg_iters > p.cg_max || iterations < 0 || !p.stats || p.lA)
    return (int)cudaErrorInvalidValue;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  const LmParams q{lam0, lam_factor, lam_min, lam_max, abs_tol, rel_tol};
  const int nb = n_blocks(p.N);
  GN_TRY(run_chi2(p, w, p.poses, s));
  k6_lm_init<<<1, 1, 0, s>>>(p, w, q);
  GN_CHECK();
  for (int i = 0; i < iterations; ++i) {
    GN_TRY(run_system(p, w, s));
    GN_TRY(run_factor(p, w, s));
    GN_TRY(run_cg(p, w, cg_iters, 0, s));
    GN_TRY(run_retract(p, w.cand, s));
    GN_TRY(run_chi2(p, w, w.cand, s));
    k6_lm_decide<<<1, 1, 0, s>>>(p, w, q);
    GN_CHECK();
    k6_lm_select<<<nb, kThreads, 0, s>>>(p, w);
    GN_CHECK();
  }
  return 0;
}

// Whole GN solve: phases of (iterations, cg_iters); x starts at zero and,
// with warm, seeds each CG from the previous GN step's dx. One launch of
// k6_gn_wide in wide_shape's shape; gn6_solve_staged is the same
// computation as a staged sequence (404 launches an iteration at
// sphere2500), bitwise equal. At most kMaxPhases phases.
int gn6_solve(const Gn6Problem* pp, int n_phases, const int* phase_iters, const int* phase_cg,
              int warm) {
  const Gn6Problem& p = *pp;
  Phases ph;
  if (!make_phases(n_phases, phase_iters, phase_cg, p.cg_max, ph))
    return (int)cudaErrorInvalidValue;
  Shape sh;
  const cudaError_t err = wide_shape(k6_gn_wide, p.N, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(k6_gn_wide, sh, kWide, (cudaStream_t)p.stream, p, ws_of(p), ph,
                                warm);
}

// gn6_solve as the staged sequence of launches (its yardstick).
int gn6_solve_staged(const Gn6Problem* pp, int n_phases, const int* phase_iters,
                     const int* phase_cg, int warm) {
  const Gn6Problem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  Phases checked;
  if (!make_phases(n_phases, phase_iters, phase_cg, p.cg_max, checked))
    return (int)cudaErrorInvalidValue;
  if (cudaMemsetAsync(p.x, 0, sizeof(float) * 6 * (size_t)p.N, s) != cudaSuccess)
    return (int)cudaGetLastError();
  for (int ph = 0; ph < n_phases; ++ph) {
    for (int i = 0; i < phase_iters[ph]; ++i) {
      GN_TRY(run_system(p, w, s));
      GN_TRY(run_factor(p, w, s));
      GN_TRY(run_cg(p, w, phase_cg[ph], warm, s));
      GN_TRY(run_retract(p, p.poses, s));
    }
  }
  return 0;
}

}  // extern "C"
