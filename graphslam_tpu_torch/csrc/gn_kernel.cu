// Fused SE(2) Gauss-Newton and Levenberg-Marquardt for Hopper (sm_90a): the
// CUDA port of the Pallas kernels graphslam_tpu/ops/gn_kernel.py::_gn_kernel
// (K1, GN and LM modes) and graphslam_tpu/ops/pcg_kernel.py::_kernel (K3).
//
// One GN iteration is a fixed sequence of row stages:
//
//   linearize      one thread per chain/loop edge: whitened residual and
//                  Jacobians, then Aii, Aij, Ajj, gi, gj (Aij kept for H@v)
//   assemble       one thread per node: D and g from its chain neighbours,
//                  its prior and its incident loop edges (a CSR in edge
//                  order, so the sums have a fixed order and no atomics);
//                  in LM mode D's diagonal is scaled by (1 + lam)
//   PCR factor     one stage per PCR level (truncated at K levels)
//   CG, cg_iters times:
//     H@p          with the partial sums of p.Ap per 256-row block
//     update       alpha from the partials (same order in every block),
//                  x += alpha p, r -= alpha Ap
//     PCR apply    one stage per level; the last applies Dinv and adds
//                  the partial sums of r.z
//     direction    beta, p = z + beta p, rz kept on the device
//   retract        x <- x * Exp(dx) (GN: in place; LM: into a candidate)
//
// An LM iteration (gn_kernel.py:911-946) adds three: the candidate's cost
// (block partials), the decision (one thread: accept or reject, the lambda
// schedule, the stats) and the select (poses <- the candidate where
// accepted). lam and the stats live in device memory.
//
// Each stage's rows are __device__ functions that two launch shapes share.
// gn_solve (K1), gn_lm_solve (K1-LM) and gn_pcg (K3) run a whole solve as
// ONE launch of a persistent kernel on one thread-block cluster
// (persistent.cuh: k_gn_persistent, k_lm_persistent, k_pcg_persistent), a
// cluster barrier where a staged sequence has a kernel boundary; the LM
// decision runs on CTA 0's thread 0 between two barriers. The staged
// sequences, one small launch per stage on the caller's stream
// (gn_solve_staged, gn_lm_solve_staged; gn_factor then gn_cg for K3: 190
// launches a K1 GN iteration and 401 a K3 call at m3500), give bitwise the
// same results and stay as the yardsticks.
//
// K3 (gn_pcg) is the PCR factor at the exact K = ceil(log2 N) and a cold CG
// on a D, U, b and loop blocks that the caller supplies (damped in torch
// beforehand, as the JAX package damps in XLA).
//
// At m3500 size the arrays are a few MB and sit in the 50 MB L2; what bounds
// these stages is latency, not bytes or FLOPs: each is a few us of work over
// 14 row blocks, so a launch boundary (~4.8 us from the host) costs more
// than the stage. A cluster barrier in hardware costs far less.
//
// Numerics follow the TPU kernels, not the XLA solver: floor-based angle
// wrap, PCR ridge eps/3*|tr| + 1e-8 with the adjugate inverse (no 1e-8*I),
// zero-filled PCR shifts at both ends, and the Krylov-exhaustion guard
// (alpha = beta = 0 once pAp or rz <= 1e-30). Every reduction has a fixed
// order, so two runs on one card give bitwise equal poses.
//
// Line references "gn_kernel.py:N" are to graphslam_tpu/ops/gn_kernel.py.
//
// Plain C interface for ctypes: every function takes a GnProblem* whose
// pointers are device pointers, launches on problem->stream and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "se2_blocks.cuh"

extern "C" {

struct GnProblem {
  float* poses;        // (N, 3) in/out
  const float* cz;     // (c, 3) chain measurements, masked rows zero
  const float* cR;     // (c, 9) chain sqrt-information
  const float* pz;     // (N, 3) per-node prior measurement
  const float* pR;     // (N, 9) per-node prior sqrt-information (zero: none)
  const int* li;       // (El,) loop edge endpoints
  const int* lj;
  const float* lz;     // (El, 3)
  const float* lR;     // (El, 9)
  const int* csr_ptr;  // (N+1,)
  const int* csr_ent;  // (2 El,) 2*l + side, ascending l per node
  float* D;            // (N, 9) assembled diagonal blocks
  float* U;            // (N, 9) chain blocks, U[n] couples n and n+1
  float* b;            // (N, 3) right-hand side -g
  float* x;            // (N, 3) CG solution (and warm-start seed)
  float* ws;           // workspace of gn_ws_floats(...) floats
  const float* lA;     // (El, 9) loop blocks from the caller (K3), or null:
                       // K1's own, linearized into the workspace
  float* stats;        // (4,) LM state [chi2, lam, n_acc, conv], or null (GN)
  void* stream;        // cudaStream_t
  int N, c, El, K, cg_max;
  float eps, huber_delta;
};

}  // extern "C"

namespace {

// Workspace carve-up (floats).
struct Ws {
  float* Aij;       // (c+El, 9)
  float* blk;       // (c+El, 24): Aii 9, Ajj 9, gi 3, gj 3
  float* PD[2];     // PCR working blocks, ping-pong (N, 9)
  float* PU[2];
  float* PL[2];
  float* A;         // (K, N, 9) PCR coefficients alpha
  float* G;         // (K, N, 9) PCR coefficients gamma
  float* DinvF;     // (N, 9)
  float* r;         // (N, 3) CG vectors
  float* z;
  float* p;
  float* Ap;
  float* t[2];      // PCR apply ping-pong
  float* part_a;    // (n_blocks(N),) partial sums of p.Ap
  float* part_b;    // (n_blocks(N),) partial sums of r.z
  float* rz;        // (cg_max + 1,) r.z per CG iteration
  float* cand;      // (N, 3) LM candidate poses
  float* part_e;    // (n_blocks(c + El + N),) partial sums of the cost
  float* acc;       // (1,) LM: 1 where the last step was accepted
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
  const long long N9 = 9LL * N, N3 = 3LL * N;
  w.Aij = take(9 * E);
  w.blk = take(24 * E);
  for (int i = 0; i < 2; ++i) {
    w.PD[i] = take(N9);
    w.PU[i] = take(N9);
    w.PL[i] = take(N9);
  }
  w.A = take(N9 * K);
  w.G = take(N9 * K);
  w.DinvF = take(N9);
  w.r = take(N3);
  w.z = take(N3);
  w.p = take(N3);
  w.Ap = take(N3);
  w.t[0] = take(N3);
  w.t[1] = take(N3);
  w.part_a = take(n_blocks(N));
  w.part_b = take(n_blocks(N));
  w.rz = take(cg_max + 1);
  w.cand = take(N3);
  w.part_e = take(n_blocks(E + N));
  w.acc = take(1);
  w.total = off;
  return w;
}

// SE(2) exp, compose and the whitened residual (the rest of the SE(2) code
// is in se2_blocks.cuh, shared with csrc/cg_step.cu).

__device__ V3 se2_exp(const V3& v) {
  const float w = v.v[2];
  const bool small = fabsf(w) < 1e-6f;
  const float ws = small ? 1.f : w;
  const float half = ws / 2.f;
  const float sh = sinf(half);
  const float a = small ? 1.f - w * w / 6.f : sinf(ws) / ws;
  const float b = small ? w / 2.f - w * w * w / 24.f : 2.f * sh * sh / ws;
  return V3{{a * v.v[0] - b * v.v[1], b * v.v[0] + a * v.v[1], wrapf(w)}};
}

__device__ V3 se2_compose(const V3& a, const V3& b) {
  const float c = cosf(a.v[2]), s = sinf(a.v[2]);
  return V3{{a.v[0] + c * b.v[0] - s * b.v[1], a.v[1] + s * b.v[0] + c * b.v[1],
             wrapf(a.v[2] + b.v[2])}};
}

// Whitened residual only (gn_kernel.py:582-587), for the cost.
__device__ __forceinline__ V3 residual_edge(const V3& xi, const V3& xj, const V3& z,
                                            const M3& R) {
  return mvec(R, se2_log(se2_between(z, se2_between(xi, xj))));
}

// ---------------------------------------------------------------------------
// Kernels
// ---------------------------------------------------------------------------

// Edge row e < c + El: chain edge e or loop edge e - c, linearized at the
// poses; Aij into w.Aij, Aii, Ajj, gi, gj into w.blk.
__device__ __forceinline__ void linearize_row(const GnProblem& p, const Ws& w, int e) {
  V3 xi, xj, z;
  M3 R;
  float huber = -1.f;
  if (e < p.c) {
    xi = ld3(p.poses, e);
    xj = ld3(p.poses, e + 1);
    z = ld3(p.cz, e);
    R = ld9(p.cR, e);
  } else {
    const int l = e - p.c;
    xi = ld3(p.poses, p.li[l]);
    xj = ld3(p.poses, p.lj[l]);
    z = ld3(p.lz, l);
    R = ld9(p.lR, l);
    huber = p.huber_delta;
  }
  V3 rw;
  M3 Jiw, Jjw;
  linearize_edge(xi, xj, z, R, huber, rw, Jiw, Jjw);
  const M3 JiT = mT(Jiw);
  st9(w.Aij, e, mmul(JiT, Jjw));
  float* out = w.blk + 24LL * e;
  st9(out, 0, mmul(JiT, Jiw));
  st9(out + 9, 0, mmul(mT(Jjw), Jjw));
  st3(out + 18, 0, mTvec(Jiw, rw));
  st3(out + 21, 0, mTvec(Jjw, rw));
}

__global__ void k_linearize(GnProblem p, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.c + p.El) return;
  linearize_row(p, w, e);
}

// Node row n: D, b and U from its chain edges, its prior and its loop edges
// in CSR order; in LM mode D's diagonal times (1 + lam).
__device__ __forceinline__ void assemble_row(const GnProblem& p, const Ws& w, int n) {
  M3 D = m3zero();
  V3 g = v3zero();
  if (n < p.c) {  // chain edge n = (n, n+1): node n is its i end
    const float* e = w.blk + 24LL * n;
    madd(D, ld9(e, 0));
    vadd(g, ld3(e + 18, 0));
  }
  if (n >= 1 && n - 1 < p.c) {  // chain edge n-1: node n is its j end
    const float* e = w.blk + 24LL * (n - 1);
    madd(D, ld9(e + 9, 0));
    vadd(g, ld3(e + 21, 0));
  }
  {  // prior: r = Log(z^-1 x), J = Jr^{-1}(r), zero sqrt-info = no prior
    const V3 rp = se2_log(se2_between(ld3(p.pz, n), ld3(p.poses, n)));
    const M3 pR = ld9(p.pR, n);
    const M3 Jpw = mmul(pR, se2_jr_inv(rp));
    const V3 rpw = mvec(pR, rp);
    madd(D, mmul(mT(Jpw), Jpw));
    vadd(g, mTvec(Jpw, rpw));
  }
  for (int q = p.csr_ptr[n]; q < p.csr_ptr[n + 1]; ++q) {
    const int ent = p.csr_ent[q];
    const float* e = w.blk + 24LL * (p.c + (ent >> 1));
    if (ent & 1) {
      madd(D, ld9(e + 9, 0));
      vadd(g, ld3(e + 21, 0));
    } else {
      madd(D, ld9(e, 0));
      vadd(g, ld3(e + 18, 0));
    }
  }
  if (p.stats) {  // LM: Marquardt damping D_ii * (1 + lam) (gn_kernel.py:769-771)
    const float s = 1.f + p.stats[1];
    D.m[0] *= s;
    D.m[4] *= s;
    D.m[8] *= s;
  }
  st9(p.D, n, D);
  st3(p.b, n, V3{{-g.v[0], -g.v[1], -g.v[2]}});
  st9(p.U, n, n < p.c ? ld9(w.Aij, n) : m3zero());
}

__global__ void k_assemble(GnProblem p, Ws w) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  assemble_row(p, w, n);
}

// One PCR level (pcr_factor_row in se2_blocks.cuh); the last level writes
// the final inverse instead of D', L', U'.
__global__ void k_pcr_factor(GnProblem p, Ws w, int k, const float* Ds, const float* Us,
                             const float* Ls, float* Dd, float* Ud, float* Ld, int last) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  pcr_factor_row(n, p.N, k, p.eps, Ds, Us, Ls, p.U, w.A, w.G, w.DinvF, Dd, Ud, Ld, last);
}

// One PCR apply level (pcr_apply_row); the last level also applies Dinv
// and, with rdot, adds the partial sums of rdot.out per block to part.
__global__ void k_pcr_apply(GnProblem p, Ws w, int k, const float* in, float* out, int last,
                            const float* rdot, float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float val = 0.f;
  if (n < p.N) {
    const V3 o = pcr_apply_row(n, p.N, k, w.A, w.G, w.DinvF, in, out, last);
    if (rdot) val = vdot(ld3(rdot, n), o);
  }
  if (part) block_sum_to(val, part, blockIdx.x);
}

// Row n of out = H v (gn_kernel.py:788-824): diagonal blocks, chain U and
// L = U^T of the previous node, then the node's loop edges in CSR order.
// Returns v[n].out[n], the row's term of v.Hv.
__device__ __forceinline__ float hvp_row(const GnProblem& p, const Ws& w, const float* v,
                                         float* out, int n) {
  const V3 vn = ld3(v, n);
  V3 o = mvec(ld9(p.D, n), vn);
  if (n + 1 < p.N) vadd(o, mvec(ld9(p.U, n), ld3(v, n + 1)));
  if (n >= 1) vadd(o, mTvec(ld9(p.U, n - 1), ld3(v, n - 1)));
  const float* LA = p.lA ? p.lA : w.Aij + 9LL * p.c;
  for (int q = p.csr_ptr[n]; q < p.csr_ptr[n + 1]; ++q) {
    const int ent = p.csr_ent[q];
    const int l = ent >> 1;
    const M3 A = ld9(LA, l);
    if (ent & 1) vadd(o, mTvec(A, ld3(v, p.li[l])));  // node is j: A^T v_i
    else vadd(o, mvec(A, ld3(v, p.lj[l])));           // node is i: A v_j
  }
  st3(out, n, o);
  return vdot(vn, o);
}

// out = H v; with part, adds the partial sums of v.out per block.
__global__ void k_hvp(GnProblem p, Ws w, const float* v, float* out, float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float val = 0.f;
  if (n < p.N) {
    const float d = hvp_row(p, w, v, out, n);
    if (part) val = d;
  }
  if (part) block_sum_to(val, part, blockIdx.x);
}

// Start of CG at row n: cold x = 0, r = b; warm r = b - H x (Ap holds H x).
__device__ __forceinline__ void cg_init_row(const GnProblem& p, const Ws& w, int n, int warm) {
  V3 r = ld3(p.b, n);
  if (warm) {
    const V3 hx = ld3(w.Ap, n);
#pragma unroll
    for (int a = 0; a < 3; ++a) r.v[a] -= hx.v[a];
  } else {
    st3(p.x, n, v3zero());
  }
  st3(w.r, n, r);
}

__global__ void k_cg_init(GnProblem p, Ws w, int warm) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  cg_init_row(p, w, n, warm);
}

// alpha = rz / pAp, guarded (the same in every block: the partials are
// summed in block order).
__device__ __forceinline__ float cg_alpha(const Ws& w, int N, int it) {
  const float pAp = sum_partials(w.part_a, n_blocks(N));
  const float rz = w.rz[it];
  return pAp > kTiny ? rz / fmaxf(pAp, kTiny) : 0.f;
}

// Row n: x += alpha p; r -= alpha Ap.
__device__ __forceinline__ void cg_update_row(const GnProblem& p, const Ws& w, int n,
                                              float alpha) {
  V3 x = ld3(p.x, n), r = ld3(w.r, n);
  const V3 pv = ld3(w.p, n), ap = ld3(w.Ap, n);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    x.v[a] += alpha * pv.v[a];
    r.v[a] -= alpha * ap.v[a];
  }
  st3(p.x, n, x);
  st3(w.r, n, r);
}

__global__ void k_cg_update(GnProblem p, Ws w, int it) {
  const float alpha = cg_alpha(w, p.N, it);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  cg_update_row(p, w, n, alpha);
}

// beta = rz_new / rz[it], guarded (0 at init).
__device__ __forceinline__ float cg_beta(const Ws& w, float rz_new, int it, int init) {
  float beta = 0.f;
  if (!init) {
    const float rz = w.rz[it];
    beta = rz > kTiny ? rz_new / fmaxf(rz, kTiny) : 0.f;
  }
  return beta;
}

// Row n: p = z (init) or z + beta p.
__device__ __forceinline__ void cg_direction_row(const Ws& w, int n, float beta, int init) {
  const V3 z = ld3(w.z, n);
  if (init) {
    st3(w.p, n, z);
    return;
  }
  V3 pv = ld3(w.p, n);
#pragma unroll
  for (int a = 0; a < 3; ++a) pv.v[a] = z.v[a] + beta * pv.v[a];
  st3(w.p, n, pv);
}

// rz_new from the partials; p = z (init) or z + beta p; rz[it+1] = rz_new.
__global__ void k_cg_direction(GnProblem p, Ws w, int it, int init) {
  const float rz_new = sum_partials(w.part_b, n_blocks(p.N));
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  const float beta = cg_beta(w, rz_new, it, init);
  if (blockIdx.x == 0 && threadIdx.x == 0) w.rz[init ? 0 : it + 1] = rz_new;
  if (n >= p.N) return;
  cg_direction_row(w, n, beta, init);
}

// out = poses * Exp(x) at row n; out may be poses itself (each thread owns
// its node).
__device__ __forceinline__ void retract_row(const GnProblem& p, float* out, int n) {
  st3(out, n, se2_compose(ld3(p.poses, n), se2_exp(ld3(p.x, n))));
}

__global__ void k_retract(GnProblem p, float* out) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  retract_row(p, out, n);
}

// Cost of `poses` (gn_kernel.py:651-690): squares on chain and prior rows,
// Huber rho = 2 delta n - delta^2 (n = |rw|, where n > delta) on every loop
// edge when delta > 0. Row t takes chain edge t (t < c), loop edge t - c
// (t < c + El) or the prior of node t - c - El; 0 past them.
__device__ __forceinline__ float chi2_row(const GnProblem& p, const float* poses, int t) {
  float e = 0.f;
  if (t < p.c) {
    const V3 rw = residual_edge(ld3(poses, t), ld3(poses, t + 1), ld3(p.cz, t), ld9(p.cR, t));
    e = vdot(rw, rw);
  } else if (t < p.c + p.El) {
    const int l = t - p.c;
    const V3 rw = residual_edge(ld3(poses, p.li[l]), ld3(poses, p.lj[l]), ld3(p.lz, l),
                                ld9(p.lR, l));
    e = vdot(rw, rw);
    if (p.huber_delta > 0.f) {
      const float nrm = sqrtf(fmaxf(e, 1e-24f));
      if (!(nrm <= p.huber_delta)) e = 2.f * p.huber_delta * nrm - p.huber_delta * p.huber_delta;
    }
  } else if (t < p.c + p.El + p.N) {
    const int n = t - p.c - p.El;
    const V3 rp = mvec(ld9(p.pR, n), se2_log(se2_between(ld3(p.pz, n), ld3(poses, n))));
    e = vdot(rp, rp);
  }
  return e;
}

// The per-block partials of the cost go to w.part_e and are summed in block
// order by lm_decide / k_cost_total.
__global__ void k_chi2(GnProblem p, Ws w, const float* poses) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  block_sum_to(chi2_row(p, poses, t), w.part_e, blockIdx.x);
}

__device__ __forceinline__ float cost_total(const GnProblem& p, const Ws& w) {
  float acc = 0.f;
  const int nb = n_blocks((long long)p.c + p.El + p.N);
  for (int i = 0; i < nb; ++i) acc += w.part_e[i];
  return acc;
}

// One thread: the cost from k_chi2's partials into out[0].
__global__ void k_cost_total(GnProblem p, Ws w, float* out) { out[0] = cost_total(p, w); }

struct LmParams {
  float lam0, lam_factor, lam_min, lam_max, abs_tol, rel_tol;
};

// One thread: stats = [chi2(poses0), lam0, 0, 0].
__device__ __forceinline__ void lm_init(const GnProblem& p, const Ws& w, const LmParams& q) {
  p.stats[0] = cost_total(p, w);
  p.stats[1] = q.lam0;
  p.stats[2] = 0.f;
  p.stats[3] = 0.f;
}

__global__ void k_lm_init(GnProblem p, Ws w, LmParams q) { lm_init(p, w, q); }

// One thread: accept or reject the candidate whose cost k_chi2 just summed
// (gn_kernel.py:927-944). A NaN cost rejects; conv latches the _lm_loop
// test with lam before its update.
__device__ __forceinline__ void lm_decide(const GnProblem& p, const Ws& w, const LmParams& q) {
  const float new_err = cost_total(p, w);
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

__global__ void k_lm_decide(GnProblem p, Ws w, LmParams q) { lm_decide(p, w, q); }

// Row n: poses <- candidate where the last step was accepted.
__device__ __forceinline__ void lm_select_row(const GnProblem& p, const Ws& w, int n) {
  if (w.acc[0] != 0.f) st3(p.poses, n, ld3(w.cand, n));
}

__global__ void k_lm_select(GnProblem p, Ws w) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  lm_select_row(p, w, n);
}

// ---------------------------------------------------------------------------
// Persistent kernels: K3, K1 and K1-LM, each ONE launch on a thread-block
// cluster (persistent.cuh), the staged launches' rows with a cluster
// barrier in place of each kernel boundary
// ---------------------------------------------------------------------------

// run_system's two stages: the E edge rows, then the N node rows.
__device__ __forceinline__ void system_stages(const GnProblem& p, const Ws& w) {
  for_rows(p.c + p.El, [&](int e) { linearize_row(p, w, e); });
  cluster_sync();
  for_rows(p.N, [&](int n) { assemble_row(p, w, n); });
  cluster_sync();
}

// run_cg's stages: with warm, H x first; the init, the first K apply levels
// and the direction, then cg_iters x (H@p, update, K apply levels,
// direction). The last direction has no barrier after it.
__device__ __forceinline__ void cg_stages(const GnProblem& p, const Ws& w, int cg_iters,
                                          int warm) {
  const int N = p.N, K = p.K;
  if (warm) {
    for_rows(N, [&](int n) { hvp_row(p, w, p.x, w.Ap, n); });
    cluster_sync();
  }
  for_rows(N, [&](int n) { cg_init_row(p, w, n, warm); });
  cluster_sync();
  pcr_apply_stages(N, K, w.A, w.G, w.DinvF, w.r, w.t[0], w.t[1], w.z, w.r, w.part_b);
  float rz_new = sum_partials(w.part_b, n_blocks(N));
  if (blockIdx.x == 0 && threadIdx.x == 0) w.rz[0] = rz_new;
  for_rows(N, [&](int n) { cg_direction_row(w, n, 0.f, 1); });
  for (int it = 0; it < cg_iters; ++it) {
    cluster_sync();
    for_rows_sum(N, w.part_a, [&](int n) { return hvp_row(p, w, w.p, w.Ap, n); });
    cluster_sync();
    const float alpha = cg_alpha(w, N, it);
    for_rows(N, [&](int n) { cg_update_row(p, w, n, alpha); });
    cluster_sync();
    pcr_apply_stages(N, K, w.A, w.G, w.DinvF, w.r, w.t[0], w.t[1], w.z, w.r, w.part_b);
    rz_new = sum_partials(w.part_b, n_blocks(N));
    const float beta = cg_beta(w, rz_new, it, 0);
    if (blockIdx.x == 0 && threadIdx.x == 0) w.rz[it + 1] = rz_new;
    for_rows(N, [&](int n) { cg_direction_row(w, n, beta, 0); });
  }
}

// K3: the K PCR factor levels and a cold CG -- run_factor and run_cg(warm
// = 0): 2K + 2 + cg_iters (K + 3) stages, 401 at m3500 (K = 12, cg 25).
__global__ void __launch_bounds__(kThreads, 1) k_pcg_persistent(GnProblem p, Ws w,
                                                                 int cg_iters) {
  pcr_factor_stages(p.N, p.K, p.eps, p.D, p.U, w.PD[0], w.PD[1], w.PU[0], w.PU[1], w.PL[0],
                    w.PL[1], w.A, w.G, w.DinvF);
  cg_stages(p, w, cg_iters, 0);
}

// K1's GN mode: x = 0, then per GN iteration of each phase run_system,
// run_factor, run_cg and run_retract in place: 2 + K + (warm) + 2 + K +
// cg (K + 3) + 1 stages an iteration (190 at m3500: K = 4, cg 25).
__global__ void __launch_bounds__(kThreads, 1) k_gn_persistent(GnProblem p, Ws w, Phases ph,
                                                                int warm) {
  for_rows(p.N, [&](int n) { st3(p.x, n, v3zero()); });
  for (int f = 0; f < ph.n; ++f) {
    for (int i = 0; i < ph.iters[f]; ++i) {
      cluster_sync();
      system_stages(p, w);
      pcr_factor_stages(p.N, p.K, p.eps, p.D, p.U, w.PD[0], w.PD[1], w.PU[0], w.PU[1],
                        w.PL[0], w.PL[1], w.A, w.G, w.DinvF);
      cg_stages(p, w, ph.cg[f], warm);
      cluster_sync();
      for_rows(p.N, [&](int n) { retract_row(p, p.poses, n); });
    }
  }
}

// K1's LM mode: the cost of the poses and lm_init, then per iteration the
// GN stages with a cold CG, the retract into the candidate, its cost (c +
// El + N rows), lm_decide on CTA 0's thread 0 between two barriers, and the
// select.
__global__ void __launch_bounds__(kThreads, 1) k_lm_persistent(GnProblem p, Ws w, LmParams q,
                                                                int iterations, int cg_iters) {
  const int T = p.c + p.El + p.N;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  for_rows_sum(T, w.part_e, [&](int t) { return chi2_row(p, p.poses, t); });
  cluster_sync();
  if (lead) lm_init(p, w, q);
  for (int i = 0; i < iterations; ++i) {
    cluster_sync();
    system_stages(p, w);
    pcr_factor_stages(p.N, p.K, p.eps, p.D, p.U, w.PD[0], w.PD[1], w.PU[0], w.PU[1], w.PL[0],
                      w.PL[1], w.A, w.G, w.DinvF);
    cg_stages(p, w, cg_iters, 0);
    cluster_sync();
    for_rows(p.N, [&](int n) { retract_row(p, w.cand, n); });
    cluster_sync();
    for_rows_sum(T, w.part_e, [&](int t) { return chi2_row(p, w.cand, t); });
    cluster_sync();
    if (lead) lm_decide(p, w, q);
    cluster_sync();
    for_rows(p.N, [&](int n) { lm_select_row(p, w, n); });
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

Ws ws_of(const GnProblem& p) { return layout(p.N, p.c, p.El, p.K, p.cg_max, p.ws); }

int run_system(const GnProblem& p, const Ws& w, cudaStream_t s) {
  const int E = p.c + p.El;
  if (E > 0) {
    k_linearize<<<n_blocks(E), kThreads, 0, s>>>(p, w);
    GN_CHECK();
  }
  k_assemble<<<n_blocks(p.N), kThreads, 0, s>>>(p, w);
  GN_CHECK();
  return 0;
}

int run_factor(const GnProblem& p, const Ws& w, cudaStream_t s) {
  for (int k = 0; k < p.K; ++k) {
    const int src = (k - 1) & 1, dst = k & 1;
    const float* Ds = k == 0 ? p.D : w.PD[src];
    const float* Us = k == 0 ? p.U : w.PU[src];
    const float* Ls = k == 0 ? nullptr : w.PL[src];
    k_pcr_factor<<<n_blocks(p.N), kThreads, 0, s>>>(p, w, k, Ds, Us, Ls, w.PD[dst], w.PU[dst],
                                                   w.PL[dst], k == p.K - 1);
    GN_CHECK();
  }
  return 0;
}

int run_precond(const GnProblem& p, const Ws& w, const float* in, float* out,
                const float* rdot, float* part, cudaStream_t s) {
  const float* src = in;
  for (int k = 0; k < p.K; ++k) {
    const bool last = k == p.K - 1;
    float* dst = last ? out : w.t[k & 1];
    k_pcr_apply<<<n_blocks(p.N), kThreads, 0, s>>>(p, w, k, src, dst, last,
                                                  last ? rdot : nullptr, last ? part : nullptr);
    GN_CHECK();
    src = dst;
  }
  return 0;
}

int run_cg(const GnProblem& p, const Ws& w, int cg_iters, int warm, cudaStream_t s) {
  const int nb = n_blocks(p.N);
  if (warm) {
    k_hvp<<<nb, kThreads, 0, s>>>(p, w, p.x, w.Ap, nullptr);
    GN_CHECK();
  }
  k_cg_init<<<nb, kThreads, 0, s>>>(p, w, warm);
  GN_CHECK();
  GN_TRY(run_precond(p, w, w.r, w.z, w.r, w.part_b, s));
  k_cg_direction<<<nb, kThreads, 0, s>>>(p, w, 0, 1);
  GN_CHECK();
  for (int it = 0; it < cg_iters; ++it) {
    k_hvp<<<nb, kThreads, 0, s>>>(p, w, w.p, w.Ap, w.part_a);
    GN_CHECK();
    k_cg_update<<<nb, kThreads, 0, s>>>(p, w, it);
    GN_CHECK();
    GN_TRY(run_precond(p, w, w.r, w.z, w.r, w.part_b, s));
    k_cg_direction<<<nb, kThreads, 0, s>>>(p, w, it, 0);
    GN_CHECK();
  }
  return 0;
}

int run_retract(const GnProblem& p, float* out, cudaStream_t s) {
  k_retract<<<n_blocks(p.N), kThreads, 0, s>>>(p, out);
  GN_CHECK();
  return 0;
}

int run_chi2(const GnProblem& p, const Ws& w, const float* poses, cudaStream_t s) {
  k_chi2<<<n_blocks((long long)p.c + p.El + p.N), kThreads, 0, s>>>(p, w, poses);
  GN_CHECK();
  return 0;
}

}  // namespace

extern "C" {

long long gn_ws_floats(int N, int c, int El, int K, int cg_max) {
  return layout(N, c, El, K, cg_max, nullptr).total;
}

const char* gn_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int gn_system(const GnProblem* p) {
  return run_system(*p, ws_of(*p), (cudaStream_t)p->stream);
}

int gn_factor(const GnProblem* p) {
  return run_factor(*p, ws_of(*p), (cudaStream_t)p->stream);
}

int gn_precond(const GnProblem* p, const float* in, float* out) {
  return run_precond(*p, ws_of(*p), in, out, nullptr, nullptr, (cudaStream_t)p->stream);
}

int gn_cg(const GnProblem* p, int cg_iters, int warm) {
  if (cg_iters > p->cg_max) return (int)cudaErrorInvalidValue;
  return run_cg(*p, ws_of(*p), cg_iters, warm, (cudaStream_t)p->stream);
}

int gn_retract(const GnProblem* p) { return run_retract(*p, p->poses, (cudaStream_t)p->stream); }

int gn_problem_size() { return (int)sizeof(GnProblem); }

// The cost of `poses` (N, 3) into out[0]: K1's LM cost pass on its own.
int gn_chi2(const GnProblem* pp, const float* poses, float* out) {
  const GnProblem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  GN_TRY(run_chi2(p, w, poses, s));
  k_cost_total<<<1, 1, 0, s>>>(p, w, out);
  GN_CHECK();
  return 0;
}

// K3: exact-K PCR factor and a cold CG of cg_iters on the caller's D, U, b
// and loop blocks p->lA; the solution lands in p->x. One launch of the
// persistent kernel on one thread-block cluster; gn_factor then
// gn_cg(cg_iters, 0) on the same problem is the same computation as a
// staged sequence of 2K + 2 + cg_iters (K + 3) launches, bitwise equal.
int gn_pcg(const GnProblem* pp, int cg_iters) {
  const GnProblem& p = *pp;
  if (cg_iters < 0 || cg_iters > p.cg_max) return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(k_pcg_persistent, p.N, (cudaStream_t)p.stream, p, ws_of(p),
                             cg_iters);
}

// K1's LM mode (gn_kernel.py:911-946): `iterations` damped steps, each a
// cold CG of cg_iters, a candidate, its cost and the accept/reject; the
// stats [chi2, lam, n_acc, conv] stay in p->stats. One launch of
// k_lm_persistent on one thread-block cluster; gn_lm_solve_staged is the
// same computation as 2 + iterations (2 + K + 2 + K + cg (K + 3) + 4)
// launches, bitwise equal. No host synchronization.
int gn_lm_solve(const GnProblem* pp, int iterations, int cg_iters, float lam0,
                float lam_factor, float lam_min, float lam_max, float abs_tol,
                float rel_tol) {
  const GnProblem& p = *pp;
  if (cg_iters < 0 || cg_iters > p.cg_max || iterations < 0 || !p.stats || p.lA)
    return (int)cudaErrorInvalidValue;
  const LmParams q{lam0, lam_factor, lam_min, lam_max, abs_tol, rel_tol};
  return (int)launch_cluster(k_lm_persistent, p.N, (cudaStream_t)p.stream, p, ws_of(p), q,
                             iterations, cg_iters);
}

// gn_lm_solve as the staged sequence of launches (its yardstick).
int gn_lm_solve_staged(const GnProblem* pp, int iterations, int cg_iters, float lam0,
                       float lam_factor, float lam_min, float lam_max, float abs_tol,
                       float rel_tol) {
  const GnProblem& p = *pp;
  if (cg_iters < 0 || cg_iters > p.cg_max || iterations < 0 || !p.stats || p.lA)
    return (int)cudaErrorInvalidValue;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  const LmParams q{lam0, lam_factor, lam_min, lam_max, abs_tol, rel_tol};
  const int nb = n_blocks(p.N);
  GN_TRY(run_chi2(p, w, p.poses, s));
  k_lm_init<<<1, 1, 0, s>>>(p, w, q);
  GN_CHECK();
  for (int i = 0; i < iterations; ++i) {
    GN_TRY(run_system(p, w, s));
    GN_TRY(run_factor(p, w, s));
    GN_TRY(run_cg(p, w, cg_iters, 0, s));
    GN_TRY(run_retract(p, w.cand, s));
    GN_TRY(run_chi2(p, w, w.cand, s));
    k_lm_decide<<<1, 1, 0, s>>>(p, w, q);
    GN_CHECK();
    k_lm_select<<<nb, kThreads, 0, s>>>(p, w);
    GN_CHECK();
  }
  return 0;
}

// Whole solve: phases of (iterations, cg_iters); x starts at zero and, with
// warm, seeds each CG from the previous GN step's dx. One launch of
// k_gn_persistent on one thread-block cluster; gn_solve_staged is the same
// computation as a staged sequence (190 launches an iteration at m3500),
// bitwise equal. At most kMaxPhases phases.
int gn_solve(const GnProblem* pp, int n_phases, const int* phase_iters, const int* phase_cg,
             int warm) {
  const GnProblem& p = *pp;
  Phases ph;
  if (!make_phases(n_phases, phase_iters, phase_cg, p.cg_max, ph))
    return (int)cudaErrorInvalidValue;
  return (int)launch_cluster(k_gn_persistent, p.N, (cudaStream_t)p.stream, p, ws_of(p), ph,
                             warm);
}

// gn_solve as the staged sequence of launches (its yardstick).
int gn_solve_staged(const GnProblem* pp, int n_phases, const int* phase_iters,
                    const int* phase_cg, int warm) {
  const GnProblem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  Phases checked;
  if (!make_phases(n_phases, phase_iters, phase_cg, p.cg_max, checked))
    return (int)cudaErrorInvalidValue;
  if (cudaMemsetAsync(p.x, 0, sizeof(float) * 3 * (size_t)p.N, s) != cudaSuccess)
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
