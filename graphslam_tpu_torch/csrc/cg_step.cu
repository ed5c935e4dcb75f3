// The three kernels of a distributed SE(2) Gauss-Newton iteration for Hopper
// (sm_90a): the CUDA port of the Pallas kernels in
// graphslam_tpu/parallel/cg_step.py, `stage_a` (K6a, _stage_a_kernel :200),
// `gn_setup` (K6b, _gn_setup_kernel :323) and `cg_step` (K6c,
// _cg_step_kernel :90). One process runs them per rank; the all-reduces
// between them are the caller's (torch.distributed), so each entry point is
// one launch on the caller's stream with no host synchronization:
//
//   cg_stage_a    ONE launch of cg_stage_a_persistent (persistent.cuh's
//                 persistent-stage routine), one thread a row on 64-thread
//                 CTAs over max(N, c + El) rows: a cluster, or a cooperative
//                 grid beyond 16 CTAs (m3500: 85 CTAs):
//                   linearize  one row per chain edge and per loop edge of
//                              this rank: Aii, Aij, Ajj, gi, gj (the loop
//                              Aij kept as the CG matvec's stash)
//                   assemble   one row per node: D = w (Aii[n] + Ajj[n-1])
//                              + this rank's loop blocks, summed through a
//                              CSR of the node's live edges in edge order
//                              (no atomics); U = w Aij; g alike. w =
//                              w_chain is 1 on rank 0 and 0 elsewhere, so
//                              the all-reduce counts the chain once.
//   cg_gn_setup   ONE launch of cg_gn_setup_persistent, likewise over N
//                 rows (m3500: a 55-CTA grid):
//                   setup      one row per node: + prior blocks, D_ii (1 +
//                              lam), b = -g
//                   factor     the K PCR factor levels (pcr_factor_row,
//                              se2_blocks.cuh)
//   cg_step       ONE launch of cg_step_persistent on a thread-block
//                 cluster, its stages separated by cluster barriers:
//                   update     alpha = rz / (s0 + s1), guarded; x += alpha
//                              p; r -= alpha (chain_Ap + tile_Ap)
//                   PCR apply  K levels; the last applies Dinv and writes
//                              block partials of r.z
//                   direction  beta, p = z + beta p
//                   H@p        chain_Ap = (D + U + L) p and this rank's
//                              loop H p, each with block partials of p.()
//                   finish     CTA 0's thread 0: rz, s0 and the s1 partial
//   cg_stage_a_staged, cg_gn_setup_staged, cg_step_staged  the same stages
//                 as 2, 1 + K and K + 4 launches (cg_linearize, cg_assemble;
//                 cg_setup, K cg_pcr_factor; cg_update, K cg_pcr_apply,
//                 cg_direction, cg_hvp, cg_finish), bitwise equal: the
//                 yardsticks, never on the path
//
// so a GN iteration is 1 + 1 + (cg + 1) launches. The scalars rz, s0
// (scal) and s1 (the last entry of the all-reduced [tile_Ap; s1]) stay in
// device memory; every reduction is a fixed shared-memory tree
// per 256-row block and a sum of the block partials in index order, so two
// runs on one card are bitwise equal.
//
// What bounds it: at m3500 size (N = 3500, ~1900 loop edges) a CG pass
// touches ~2 MB, all of it in the 50 MB L2, a GN iteration is ~35 MFLOP,
// and each stage covers 14 blocks of 256 threads: stage latency and the
// host bound it, not bytes or FLOPs. The persistent launches remove the
// launch gaps between stages and all but one host launch call of each
// entry (K + 3 a CG pass, K a setup, 1 a stage A).
//
// Numerics follow the TPU kernels and csrc/gn_kernel.cu, whose SE(2) and
// PCR device code both files take from se2_blocks.cuh: floor-based angle
// wrap, the PCR ridge
// eps/3 |tr| + 1e-8 with the adjugate inverse, zero-filled PCR shifts at
// both ends (the TPU kernel pads to a multiple of 1024 nodes with identity
// rows; the real rows are decoupled from them, so PCR over exactly N gives
// the same real rows), and the Krylov guards pHp > 1e-30, rz > 1e-30. Loop
// gathers are float32: the TPU's bf16 hi/lo splits are not imitated.
//
// Plain C interface for ctypes: every function takes a CgProblem* whose
// pointers are device pointers, launches on problem->stream and returns
// cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "se2_blocks.cuh"

extern "C" {

struct CgProblem {
  const float* poses;  // (N, 3)
  const float* cz;     // (c, 3) chain measurements, masked rows zero
  const float* cR;     // (c, 9) chain sqrt-information
  const float* pz;     // (N, 3) per-node prior measurement
  const float* pR;     // (N, 9) per-node prior sqrt-information (zero: none)
  const int* li;       // (El,) this rank's loop edges
  const int* lj;
  const float* lz;     // (El, 3)
  const float* lR;     // (El, 9)
  const int* csr_ptr;  // (N+1,)
  const int* csr_ent;  // (2 El,) 2*l + side, ascending l per node
  float* payload;      // (21 N): D (N, 9), U (N, 9), g (N, 3); out of K6a,
                       // all-reduced, then in to K6b
  float* Aij;          // (El, 9) loop blocks, out of K6a
  float* D;            // (N, 9) damped diagonal blocks, out of K6b
  float* A;            // (K, N, 9) PCR alpha
  float* G;            // (K, N, 9) PCR gamma
  float* Dinv;         // (N, 9) PCR final inverse
  float* b;            // (N, 3) -g
  float* ws;           // workspace of cg_ws_floats(...) floats
  void* stream;        // cudaStream_t
  int N, c, El, K;
  float eps, huber_delta, w_chain;
};

}  // extern "C"

namespace {

// Workspace carve-up (floats).
struct Ws {
  float* blk;       // (c+El, 24): Aii 9, Ajj 9, gi 3, gj 3
  float* cAij;      // (c, 9) chain Aij
  float* PD[2];     // PCR working blocks, ping-pong (N, 9)
  float* PU[2];
  float* PL[2];
  float* t[2];      // PCR apply ping-pong (N, 3)
  float* z;         // (N, 3)
  float* part_a;    // (n_blocks(N),) partial sums of p.chain_Ap
  float* part_b;    // (n_blocks(N),) partial sums of r.z
  float* part_c;    // (n_blocks(N),) partial sums of p.tile_Ap
  long long total;
};

Ws layout(int N, int c, int El, float* base) {
  Ws w;
  long long off = 0;
  auto take = [&](long long n) {
    float* ptr = base ? base + off : nullptr;
    off += n;
    return ptr;
  };
  const long long N9 = 9LL * N, N3 = 3LL * N;
  w.blk = take(24LL * ((long long)c + El));
  w.cAij = take(9LL * c);
  for (int i = 0; i < 2; ++i) {
    w.PD[i] = take(N9);
    w.PU[i] = take(N9);
    w.PL[i] = take(N9);
    w.t[i] = take(N3);
  }
  w.z = take(N3);
  w.part_a = take(n_blocks(N));
  w.part_b = take(n_blocks(N));
  w.part_c = take(n_blocks(N));
  w.total = off;
  return w;
}

// The block partials summed in index order, by one thread.
__device__ __forceinline__ float sum_in_order(const float* part, int n) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc += part[i];
  return acc;
}

// ---------------------------------------------------------------------------
// K6a: stage A
// ---------------------------------------------------------------------------

// The one-thread row functions of K6a and K6b below are __noinline__: the
// staged kernels and the persistent ones call one compiled body, so the two
// launch shapes round alike (inlined into kernels of other register
// budgets, nvcc may contract one source to FMAs differently; PERF.md).

// Row e < c: chain edge (e, e+1); else this rank's loop edge e - c.
__device__ __noinline__ void linearize_row(const CgProblem& p, const Ws& w, int e) {
  V3 xi, xj, z;
  M3 R;
  float huber = -1.f;
  float* aij;
  if (e < p.c) {
    xi = ld3(p.poses, e);
    xj = ld3(p.poses, e + 1);
    z = ld3(p.cz, e);
    R = ld9(p.cR, e);
    aij = w.cAij + 9LL * e;
  } else {
    const int l = e - p.c;
    xi = ld3(p.poses, p.li[l]);
    xj = ld3(p.poses, p.lj[l]);
    z = ld3(p.lz, l);
    R = ld9(p.lR, l);
    huber = p.huber_delta;
    aij = p.Aij + 9LL * l;
  }
  V3 rw;
  M3 Jiw, Jjw;
  linearize_edge(xi, xj, z, R, huber, rw, Jiw, Jjw);
  const M3 JiT = mT(Jiw);
  st9(aij, 0, mmul(JiT, Jjw));
  float* out = w.blk + 24LL * e;
  st9(out, 0, mmul(JiT, Jiw));
  st9(out + 9, 0, mmul(mT(Jjw), Jjw));
  st3(out + 18, 0, mTvec(Jiw, rw));
  st3(out + 21, 0, mTvec(Jjw, rw));
}

__global__ void cg_linearize(CgProblem p, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.c + p.El) return;
  linearize_row(p, w, e);
}

// Node n's payload rows: D = w (Aii[n] + Ajj[n-1]) + loop sum, U = w Aij[n],
// g = w (gi[n] + gj[n-1]) + loop sum (cg_step.py:224-233, 281).
__device__ __noinline__ void assemble_row(const CgProblem& p, const Ws& w, int n) {
  M3 D = m3zero(), U = m3zero();
  V3 g = v3zero();
  if (n < p.c) {  // chain edge n = (n, n+1): node n is its i end
    const float* e = w.blk + 24LL * n;
    D = ld9(e, 0);
    g = ld3(e + 18, 0);
    U = ld9(w.cAij, n);
  }
  if (n >= 1 && n - 1 < p.c) {  // chain edge n-1: node n is its j end
    const float* e = w.blk + 24LL * (n - 1);
    madd(D, ld9(e + 9, 0));
    vadd(g, ld3(e + 21, 0));
  }
  const float wc = p.w_chain;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    D.m[k] *= wc;
    U.m[k] *= wc;
  }
#pragma unroll
  for (int a = 0; a < 3; ++a) g.v[a] *= wc;
  M3 Dl = m3zero();
  V3 gl = v3zero();
  for (int q = p.csr_ptr[n]; q < p.csr_ptr[n + 1]; ++q) {
    const int ent = p.csr_ent[q];
    const float* e = w.blk + 24LL * (p.c + (ent >> 1));
    if (ent & 1) {
      madd(Dl, ld9(e + 9, 0));
      vadd(gl, ld3(e + 21, 0));
    } else {
      madd(Dl, ld9(e, 0));
      vadd(gl, ld3(e + 18, 0));
    }
  }
  madd(D, Dl);
  vadd(g, gl);
  st9(p.payload, n, D);
  st9(p.payload + 9LL * p.N, n, U);
  st3(p.payload + 18LL * p.N, n, g);
}

__global__ void cg_assemble(CgProblem p, Ws w) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  assemble_row(p, w, n);
}

// K6a and K6b in one launch each (persistent.cuh): their rows share no
// reduction, so each stage takes one thread a row over the whole launch
// (for_flat), on CTAs of kRowThreads threads in pass_shape's shape (one pass
// over the widest stage's rows: one cluster of at most 16 CTAs, else a
// cooperative grid), with a barrier (stage_sync) where the staged sequence
// has a kernel boundary; any shape gives the staged launches' values. A row
// is one thread's long serial chain (the SE(2) log, 3x3 products and
// inverses), so the fewer rows an SM runs at once the sooner a stage ends:
// at m3500 64-thread CTAs (K6a an 85-CTA grid, K6b 55) beat 128, 256, 512
// and 1024, and a 16-CTA cluster walking passes (scripts/bench_persistent.py;
// PERF.md).
constexpr int kRowThreads = 64;

// K6a: the linearize rows over the E = c + El edges, a barrier, the
// assemble rows over the N nodes -- cg_linearize and cg_assemble, row for
// row; E = 0 still runs the assemble stage. w.blk and w.cAij, written in
// the first stage, are read in the second with plain loads.
__global__ void __launch_bounds__(kRowThreads, 1) cg_stage_a_persistent(CgProblem p, Ws w) {
  for_flat(p.c + p.El, [&](int e) { linearize_row(p, w, e); });
  stage_sync();
  for_flat(p.N, [&](int n) { assemble_row(p, w, n); });
}

// ---------------------------------------------------------------------------
// K6b: priors, damping and the PCR factor
// ---------------------------------------------------------------------------

// Row n: D = payload D + Jp^T Jp, its diagonal times (1 + lam); b = -(g +
// Jp^T rp) (cg_step.py:340-372).
__device__ __noinline__ void setup_row(const CgProblem& p, const float* lam, int n) {
  M3 D = ld9(p.payload, n);
  V3 g = ld3(p.payload + 18LL * p.N, n);
  const V3 rp = se2_log(se2_between(ld3(p.pz, n), ld3(p.poses, n)));
  const M3 pR = ld9(p.pR, n);
  const M3 Jpw = mmul(pR, se2_jr_inv(rp));
  const V3 rpw = mvec(pR, rp);
  madd(D, mmul(mT(Jpw), Jpw));
  vadd(g, mTvec(Jpw, rpw));
  const float s = 1.f + lam[0];
  D.m[0] *= s;
  D.m[4] *= s;
  D.m[8] *= s;
  st9(p.D, n, D);
  st3(p.b, n, V3{{-g.v[0], -g.v[1], -g.v[2]}});
}

__global__ void cg_setup(CgProblem p, const float* lam) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  setup_row(p, lam, n);
}

// One PCR level (pcr_factor_row in se2_blocks.cuh), U at level 0 from the
// payload; the last level writes the final inverse instead of D', L', U'.
__global__ void cg_pcr_factor(CgProblem p, int k, const float* Ds, const float* Us,
                              const float* Ls, float* Dd, float* Ud, float* Ld, int last) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  pcr_factor_row(n, p.N, k, p.eps, Ds, Us, Ls, p.payload + 9LL * p.N, p.A, p.G, p.Dinv, Dd, Ud,
                 Ld, last);
}

// K6b: the setup rows, a barrier, then the K PCR factor levels
// (pcr_factor_row, se2_blocks.cuh), U at level 0 from the payload, a
// barrier after each but the last -- cg_setup and the K cg_pcr_factor
// launches, row for row. p.D, written by the setup rows, is read by level
// 0 with plain loads; lam stays on the device.
__global__ void __launch_bounds__(kRowThreads, 1) cg_gn_setup_persistent(CgProblem p, Ws w,
                                                                         const float* lam) {
  const int N = p.N;
  const float* U0 = p.payload + 9LL * N;
  for_flat(N, [&](int n) { setup_row(p, lam, n); });
  for (int k = 0; k < p.K; ++k) {
    stage_sync();
    const int src = (k - 1) & 1, dst = k & 1;
    const float* Ds = k == 0 ? p.D : w.PD[src];
    const float* Us = k == 0 ? U0 : w.PU[src];
    const float* Ls = k == 0 ? nullptr : w.PL[src];
    const int last = k == p.K - 1;
    for_flat(N, [&](int n) {
      pcr_factor_row(n, N, k, p.eps, Ds, Us, Ls, U0, p.A, p.G, p.Dinv, w.PD[dst], w.PU[dst],
                     w.PL[dst], last);
    });
  }
}

// ---------------------------------------------------------------------------
// K6c: one CG pass
// ---------------------------------------------------------------------------

// pHp = s0 + s1; alpha = rz / pHp where pHp > tiny, else 0
// (cg_step.py:119-128).
__device__ __forceinline__ float step_alpha(const CgProblem& p, const float* scal,
                                            const float* big) {
  const float pHp = scal[1] + big[3LL * p.N];
  const float rz = scal[0];
  return pHp > kTiny ? rz / fmaxf(pHp, kTiny) : 0.f;
}

// Row n: x += alpha p; r -= alpha (chain_Ap + tile_Ap).
__device__ __forceinline__ void update_row(int n, float alpha, float* x, float* r,
                                           const float* pv, const float* cap,
                                           const float* big) {
  V3 xn = ld3(x, n), rn = ld3(r, n);
  const V3 pn = ld3(pv, n), cn = ld3(cap, n), tn = ld3(big, n);
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    xn.v[a] += alpha * pn.v[a];
    rn.v[a] -= alpha * (cn.v[a] + tn.v[a]);
  }
  st3(x, n, xn);
  st3(r, n, rn);
}

__global__ void cg_update(CgProblem p, float* x, float* r, const float* pv, const float* cap,
                          const float* scal, const float* big) {
  const float alpha = step_alpha(p, scal, big);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  update_row(n, alpha, x, r, pv, cap, big);
}

// One PCR apply level (pcr_apply_row); the last level also applies Dinv and
// writes the block partials of rdot.out to part.
__global__ void cg_pcr_apply(CgProblem p, int k, const float* in, float* out, int last,
                             const float* rdot, float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float val = 0.f;
  if (n < p.N) {
    const V3 o = pcr_apply_row(n, p.N, k, p.A, p.G, p.Dinv, in, out, last);
    if (last) val = vdot(ld3(rdot, n), o);
  }
  if (last) block_sum_to(val, part, blockIdx.x);
}

// beta = rz_new / rz where rz > tiny, else 0.
__device__ __forceinline__ float step_beta(float rz_new, const float* scal) {
  const float rz = scal[0];
  return rz > kTiny ? rz_new / fmaxf(rz, kTiny) : 0.f;
}

// Row n: p = z + beta p.
__device__ __forceinline__ void direction_row(int n, float beta, const float* z, float* pv) {
  const V3 zn = ld3(z, n);
  V3 pn = ld3(pv, n);
#pragma unroll
  for (int a = 0; a < 3; ++a) pn.v[a] = zn.v[a] + beta * pn.v[a];
  st3(pv, n, pn);
}

// rz_new = r.z from the partials; beta; p = z + beta p. rz_new goes to
// scal[2] (scal[0] is still being read).
__global__ void cg_direction(CgProblem p, Ws w, float* pv, float* scal) {
  const float rz_new = sum_partials(w.part_b, n_blocks(p.N));
  const float beta = step_beta(rz_new, scal);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[2] = rz_new;
  if (n >= p.N) return;
  direction_row(n, beta, w.z, pv);
}

// Row n: chain_Ap = D p + U p[n+1] + U[n-1]^T p[n-1] (replicated) and
// tile_Ap = this rank's loop blocks times p through the CSR, into
// big[0:3N) (cg_step.py:139-187). s0 = p.chain_Ap and s1 = p.tile_Ap of
// the row.
__device__ __forceinline__ void hvp_row(const CgProblem& p, int n, const float* pv, float* cap,
                                        float* big, float& s0, float& s1) {
  const float* U = p.payload + 9LL * p.N;
  const V3 vn = ld3(pv, n);
  V3 o = mvec(ld9(p.D, n), vn);
  if (n + 1 < p.N) vadd(o, mvec(ld9(U, n), ld3(pv, n + 1)));
  if (n >= 1) vadd(o, mTvec(ld9(U, n - 1), ld3(pv, n - 1)));
  st3(cap, n, o);
  s0 = vdot(vn, o);
  V3 t = v3zero();
  for (int q = p.csr_ptr[n]; q < p.csr_ptr[n + 1]; ++q) {
    const int ent = p.csr_ent[q];
    const int l = ent >> 1;
    const M3 A = ld9(p.Aij, l);
    if (ent & 1) vadd(t, mTvec(A, ld3(pv, p.li[l])));  // node is j: A^T p_i
    else vadd(t, mvec(A, ld3(pv, p.lj[l])));           // node is i: A p_j
  }
  st3(big, n, t);
  s1 = vdot(vn, t);
}

// H@p of block blk's rows and the block partials of p.chain_Ap (part_a) and
// p.tile_Ap (part_c).
__device__ __forceinline__ void hvp_block(const CgProblem& p, const Ws& w, int blk,
                                          const float* pv, float* cap, float* big) {
  const int n = blk * kThreads + threadIdx.x;
  float s0 = 0.f, s1 = 0.f;
  if (n < p.N) hvp_row(p, n, pv, cap, big, s0, s1);
  block_sum_to(s0, w.part_a, blk);
  __syncthreads();  // thread 0 reads the shared tree before the next sum reuses it
  block_sum_to(s1, w.part_c, blk);
}

__global__ void cg_hvp(CgProblem p, Ws w, const float* pv, float* cap, float* big) {
  hvp_block(p, w, blockIdx.x, pv, cap, big);
}

// scal = [rz_new, s0, ...] and big[3N] = this rank's s1.
__device__ __forceinline__ void finish(const CgProblem& p, const Ws& w, float* scal,
                                       float* big) {
  const int nb = n_blocks(p.N);
  scal[0] = scal[2];
  scal[1] = sum_in_order(w.part_a, nb);
  big[3LL * p.N] = sum_in_order(w.part_c, nb);
}

// One thread.
__global__ void cg_finish(CgProblem p, Ws w, float* scal, float* big) { finish(p, w, scal, big); }

// K6c in one launch on a thread-block cluster (the persistent-stage routine
// of persistent.cuh): update, the K apply levels, direction, H@p, then the
// finish by CTA 0's thread 0 -- cg_step_staged's launches, row for row,
// with a cluster barrier in place of each kernel boundary (K + 3 of them).
__global__ void __launch_bounds__(kThreads, 1) cg_step_persistent(CgProblem p, Ws w, float* x,
                                                                  float* r, float* pv,
                                                                  float* cap, float* scal,
                                                                  float* big) {
  const int N = p.N;
  const float alpha = step_alpha(p, scal, big);
  for_rows(N, [&](int n) { update_row(n, alpha, x, r, pv, cap, big); });
  cluster_sync();
  pcr_apply_stages(N, p.K, p.A, p.G, p.Dinv, r, w.t[0], w.t[1], w.z, r, w.part_b);
  const float rz_new = sum_partials(w.part_b, n_blocks(N));
  const float beta = step_beta(rz_new, scal);
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[2] = rz_new;
  for_rows(N, [&](int n) { direction_row(n, beta, w.z, pv); });
  cluster_sync();
  const int nb = n_blocks(N);
  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) hvp_block(p, w, blk, pv, cap, big);
  cluster_sync();
  if (blockIdx.x == 0 && threadIdx.x == 0) finish(p, w, scal, big);
}

// ---------------------------------------------------------------------------
// Host side: launch sequences
// ---------------------------------------------------------------------------

#define CG_CHECK()                                  \
  do {                                              \
    const cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

Ws ws_of(const CgProblem& p) { return layout(p.N, p.c, p.El, p.ws); }

// K6a's and K6b's launch shape over n rows: CTAs of kRowThreads, one pass.
template <typename... KArgs>
cudaError_t row_shape(void (*kernel)(KArgs...), long long n, Shape& sh) {
  return pass_shape(kernel, kRowThreads, kRowThreads, n, sh);
}

}  // namespace

extern "C" {

long long cg_ws_floats(int N, int c, int El, int K) {
  (void)K;
  return layout(N, c, El, nullptr).total;
}

const char* cg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int cg_problem_size() { return (int)sizeof(CgProblem); }

// K6a: the payload and the Aij stash of this rank at p->poses. One launch of
// cg_stage_a_persistent in row_shape's shape over max(N, c + El) rows.
int cg_stage_a(const CgProblem* pp) {
  const CgProblem& p = *pp;
  const long long E = (long long)p.c + p.El;
  Shape sh;
  const cudaError_t err = row_shape(cg_stage_a_persistent, E > p.N ? E : p.N, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(cg_stage_a_persistent, sh, kRowThreads, (cudaStream_t)p.stream,
                                p, ws_of(p));
}

// The same stage as 2 launches (cg_linearize, cg_assemble): the staged
// sequence that cg_stage_a replaced, bitwise equal to it; a yardstick for
// checks and timings, never on the path.
int cg_stage_a_staged(const CgProblem* pp) {
  const CgProblem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int E = p.c + p.El;
  if (E > 0) {
    cg_linearize<<<n_blocks(E), kThreads, 0, s>>>(p, w);
    CG_CHECK();
  }
  cg_assemble<<<n_blocks(p.N), kThreads, 0, s>>>(p, w);
  CG_CHECK();
  return 0;
}

// K6b: D, b and the K-level PCR factor from the all-reduced payload at
// p->poses, damped by (1 + lam[0]) (lam a device pointer). One launch of
// cg_gn_setup_persistent in row_shape's shape over N rows.
int cg_gn_setup(const CgProblem* pp, const float* lam) {
  const CgProblem& p = *pp;
  Shape sh;
  const cudaError_t err = row_shape(cg_gn_setup_persistent, p.N, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(cg_gn_setup_persistent, sh, kRowThreads, (cudaStream_t)p.stream,
                                p, ws_of(p), lam);
}

// The CTAs of K6a's launch over n rows (n = max(N, c + El)) and of K6b's
// (n = N), negative where they form a cooperative grid rather than one
// cluster (0: a CUDA error).
int cg_row_ctas(long long n) {
  Shape sh;
  if (row_shape(cg_stage_a_persistent, n, sh) != cudaSuccess) return 0;
  return sh.cooperative ? -sh.ctas : sh.ctas;
}

// The same setup as 1 + K launches (cg_setup, K cg_pcr_factor): the staged
// sequence that cg_gn_setup replaced, bitwise equal to it; a yardstick for
// checks and timings, never on the path.
int cg_gn_setup_staged(const CgProblem* pp, const float* lam) {
  const CgProblem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int nb = n_blocks(p.N);
  cg_setup<<<nb, kThreads, 0, s>>>(p, lam);
  CG_CHECK();
  for (int k = 0; k < p.K; ++k) {
    const int src = (k - 1) & 1, dst = k & 1;
    const float* Ds = k == 0 ? p.D : w.PD[src];
    const float* Us = k == 0 ? p.payload + 9LL * p.N : w.PU[src];
    const float* Ls = k == 0 ? nullptr : w.PL[src];
    cg_pcr_factor<<<nb, kThreads, 0, s>>>(p, k, Ds, Us, Ls, w.PD[dst], w.PU[dst], w.PL[dst],
                                          k == p.K - 1);
    CG_CHECK();
  }
  return 0;
}

// K6c: one CG pass on the carry (x, r, p, chain_Ap (N, 3), scal (4,), big
// (3N+1,) the all-reduced [tile_Ap; s1]), in place; big then holds this
// rank's new [tile_Ap; s1] partial. One launch of the persistent kernel on
// one thread-block cluster.
int cg_step(const CgProblem* pp, float* x, float* r, float* pv, float* cap, float* scal,
            float* big) {
  const CgProblem& p = *pp;
  return (int)launch_cluster(cg_step_persistent, p.N, (cudaStream_t)p.stream, p, ws_of(p), x,
                             r, pv, cap, scal, big);
}

// The same pass as K + 4 launches (cg_update, K cg_pcr_apply, cg_direction,
// cg_hvp, cg_finish): the staged sequence that cg_step replaced, bitwise
// equal to it; a yardstick for checks and timings, never on the path.
int cg_step_staged(const CgProblem* pp, float* x, float* r, float* pv, float* cap, float* scal,
                   float* big) {
  const CgProblem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int nb = n_blocks(p.N);
  cg_update<<<nb, kThreads, 0, s>>>(p, x, r, pv, cap, scal, big);
  CG_CHECK();
  const float* src = r;
  for (int k = 0; k < p.K; ++k) {
    const bool last = k == p.K - 1;
    float* dst = last ? w.z : w.t[k & 1];
    cg_pcr_apply<<<nb, kThreads, 0, s>>>(p, k, src, dst, last, r, w.part_b);
    CG_CHECK();
    src = dst;
  }
  cg_direction<<<nb, kThreads, 0, s>>>(p, w, pv, scal);
  CG_CHECK();
  cg_hvp<<<nb, kThreads, 0, s>>>(p, w, pv, cap, big);
  CG_CHECK();
  cg_finish<<<1, 1, 0, s>>>(p, w, scal, big);
  CG_CHECK();
  return 0;
}

}  // extern "C"
