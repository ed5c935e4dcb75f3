// The three kernels of a distributed SE(3) Gauss-Newton iteration for Hopper
// (sm_90a): the CUDA port of the Pallas kernels in
// graphslam_tpu/parallel/cg_step6.py, `stage_a6` (K7a, _stage_a6_kernel
// :111), `gn_setup6` (K7b, _gn_setup6_kernel :240) and `cg_step6` (K7c,
// _cg_step6_kernel :341). They are csrc/cg_step.cu's K6a-c with SE(3) poses
// and 6x6 blocks. One process runs them per rank; the all-reduces between
// them are the caller's (torch.distributed), so each entry point runs on
// the caller's stream with no host synchronization:
//
//   cg6_stage_a   ONE launch of cg6_stage_a_persistent (below)
//                   linearize  one thread per chain edge and per loop edge
//                              of this rank: between, SO(3) log, Jr^-1,
//                              Ad(h^-1), whitening (Huber on loop edges
//                              when huber_delta > 0), then Aii, Aij, Ajj,
//                              gi, gj (the loop Aij kept as the CG
//                              matvec's stash)
//                   assemble   one thread per node: D = w (Aii[n] +
//                              Ajj[n-1]) + this rank's loop blocks, summed
//                              through a CSR of the node's live edges in
//                              edge order (no atomics); U = w Aij; g alike.
//                              w = w_chain is 1 on rank 0 and 0 elsewhere,
//                              so the all-reduce counts the chain once.
//   cg6_gn_setup  ONE launch of cg6_gn_setup_wide (below)
//                   setup      one thread per node: + prior blocks (one
//                              prior per node), D_ii (1 + lam) on the 6
//                              diagonal entries, b = -g
//                   PCR factor K levels, a group of 6 threads a 6x6 row
//   cg6_step      ONE launch of cg6_step_wide (below), one CG pass:
//                   update     alpha = rz / (s0 + s1), guarded; x += alpha
//                              p; r -= alpha (chain_Ap + tile_Ap)
//                   PCR apply  K levels, a group of 6 threads a row; the
//                              last applies Dinv and writes r.z a row
//                   direction  beta, p = z + beta p
//                   H@p        chain_Ap = (D + U + L) p and this rank's
//                              loop H p, a group of 6 threads a row, with
//                              p.chain_Ap and p.tile_Ap a row
//                   finish     CTA 0: rz, s0 and the s1 partial
//   cg6_stage_a_staged, cg6_gn_setup_staged, cg6_step_staged  the same as
//                 2, 1 + K and K + 4 small launches (cg6_linearize and
//                 cg6_assemble; cg6_setup and K cg6_pcr_factor; cg6_update,
//                 K cg6_pcr_apply, cg6_direction, cg6_hvp, cg6_finish: one
//                 thread a row, n_blocks(N) blocks of 256), bitwise equal:
//                 the yardsticks, never on the path
//
// so a CG pass is one launch and a GN iteration 1 + 1 + (cg + 1): 28 at
// sphere2500's cg 25 (staged: 2 + (K + 1) + (cg + 1) (K + 4) = 431 at K =
// 12). The scalars rz, s0 (scal) and s1 (the last entry of the all-reduced
// [tile_Ap; s1]) stay in device memory; every reduction is a fixed tree per
// 256-row block and a sum of the block partials in index order, so two runs
// on one card are bitwise equal.
//
// K7a is K6a's persistent kernel (csrc/cg_step.cu) with SE(3) rows: its
// stages keep no reduction, so each takes one thread a row over the whole
// launch on narrow CTAs (kRowThreads6), in persistent.cuh's pass_shape
// (one pass over the rows: one cluster up to 16 CTAs, else a cooperative
// grid; sphere2500: 155 CTAs).
//
// The two other persistent kernels run on K4's wide stages (se3_blocks.cuh):
// CTAs of kWide = 384 threads, each 6x6 row on a group of 6 threads with
// its slot of shared scratch, in wide_shape's shape: one pass over the rows
// (60 rows a CTA) on one cluster where that takes at most 16 CTAs, else a
// cooperative grid of as many CTAs (sphere2500: 42), a barrier where the
// staged sequence has a kernel boundary. The light rows (setup, update,
// direction) take one thread a row or a component over the whole launch.
// A reduction goes through a row buffer (va, vb, vc below) that wide_sum
// adds in the staged launches' order, so the persistent kernels give
// bitwise the staged sequences' outputs. Where the card cannot place the
// cluster or the grid, the entry returns the CUDA error; nothing falls
// back to the staged sequence.
//
// The 6x6, SE(3) and PCR device code is the fused SE(3) kernel's
// (csrc/gn6_kernel.cu), shared through se3_blocks.cuh: the ridge eps/6 |tr|
// + 1e-8 at every level, the 6x6 inverse as the Schur complement of the
// lower-right 3x3 over the 3x3 adjugate inverse, zero-filled PCR shifts at
// both ends (the TPU kernel pads to a multiple of 1024 nodes with identity
// rows and rolls circularly; the real rows are decoupled from the pad rows,
// so PCR over exactly N gives the same real rows), the SO(3) log with
// acosf, and the Krylov guards pHp > 1e-30, rz > 1e-30. Loop gathers are
// float32: the TPU's bf16 hi/lo splits are not imitated.
//
// What bounds it: at sphere2500 size (N = 2500, ~2450 loop edges) a CG pass
// reads the K = 12 level PCR factor (8.6 MB) and D, U (0.7 MB), all in the
// 50 MB L2; neither bytes nor FLOPs bound it but the latency of its ~K + 4
// dependent stages, as they bound the fused SE(3) kernel (K4).
//
// Plain C interface for ctypes: every function takes a Cg6Problem* whose
// pointers are device pointers, launches on problem->stream and returns
// the CUDA error (0 = success).

#include <cuda_runtime.h>
#include <math.h>

#include "se3_blocks.cuh"

extern "C" {

struct Cg6Problem {
  const float* poses;  // (N, 12) row-major R (9), then t (3)
  const float* cz;     // (c, 12) chain measurements, identity where masked
  const float* cW;     // (c, 36) chain sqrt-information, zero where masked
  const float* pz;     // (N, 12) per-node prior measurement (identity: none)
  const float* pW;     // (N, 36) per-node prior sqrt-information (zero: none)
  const int* li;       // (El,) this rank's loop edges
  const int* lj;
  const float* lz;     // (El, 12)
  const float* lW;     // (El, 36)
  const int* csr_ptr;  // (N+1,)
  const int* csr_ent;  // (2 El,) 2*l + side, ascending l per node, live only
  float* payload;      // (78 N): D (N, 36), U (N, 36), g (N, 6); out of K7a,
                       // all-reduced, then in to K7b
  float* Aij;          // (El, 36) loop blocks, out of K7a
  float* D;            // (N, 36) damped diagonal blocks, out of K7b
  float* A;            // (K, N, 36) PCR alpha
  float* G;            // (K, N, 36) PCR gamma
  float* Dinv;         // (N, 36) PCR final inverse
  float* b;            // (N, 6) -g
  float* ws;           // workspace of cg6_ws_floats(...) floats
  void* stream;        // cudaStream_t
  int N, c, El, K;
  float eps, huber_delta, w_chain;
};

}  // extern "C"

namespace {

// Workspace carve-up (floats).
struct Ws {
  float* blk;       // (c+El, 84): Aii 36, Ajj 36, gi 6, gj 6
  float* cAij;      // (c, 36) chain Aij
  float* PD[2];     // PCR working blocks, ping-pong (N, 36)
  float* PU[2];
  float* PL[2];
  float* t[2];      // PCR apply ping-pong (N, 6)
  float* z;         // (N, 6)
  float* part_a;    // (n_blocks(N),) partial sums of p.chain_Ap
  float* part_b;    // (n_blocks(N),) partial sums of r.z
  float* part_c;    // (n_blocks(N),) partial sums of p.tile_Ap
  float* va;        // (N,) p.chain_Ap a row, the persistent pass's
  float* vb;        // (N,) r.z a row
  float* vc;        // (N,) p.tile_Ap a row
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
  const long long N36 = 36LL * N, N6 = 6LL * N;
  w.blk = take(84LL * ((long long)c + El));
  w.cAij = take(36LL * c);
  for (int i = 0; i < 2; ++i) {
    w.PD[i] = take(N36);
    w.PU[i] = take(N36);
    w.PL[i] = take(N36);
    w.t[i] = take(N6);
  }
  w.z = take(N6);
  w.part_a = take(n_blocks(N));
  w.part_b = take(n_blocks(N));
  w.part_c = take(n_blocks(N));
  w.va = take(N);
  w.vb = take(N);
  w.vc = take(N);
  w.total = off;
  return w;
}

// The block partials summed in index order, by one thread.
__device__ __forceinline__ float sum_in_order(const float* part, int n) {
  float acc = 0.f;
  for (int i = 0; i < n; ++i) acc += part[i];
  return acc;
}

__device__ __forceinline__ void v6scale(V6& a, float s) {
#pragma unroll
  for (int i = 0; i < 6; ++i) a.v[i] *= s;
}

// ---------------------------------------------------------------------------
// K7a: stage A
// ---------------------------------------------------------------------------

// The one-thread row functions of K7a's assembly and K7b below are
// __noinline__: the staged kernels and the persistent ones call one
// compiled body, so the launch shapes round alike (inlined into kernels of
// other register budgets, nvcc contracted one source to FMAs differently;
// PERF.md). K7a's linearize row is inlined instead: as a __noinline__ body
// nvcc contracted it otherwise than inside the staged cg6_linearize it
// came from, so the payload and Aij lost their bits; inlined, it keeps
// them in the staged and the persistent kernels alike (the digests of
// scripts/bench_persistent.py part k7a, on the card; PERF.md).

// Row e < c: chain edge (e, e+1); else this rank's loop edge e - c
// (cg_step6.py:125-139, :162-179).
__device__ __forceinline__ void linearize_row6(const Cg6Problem& p, const Ws& w, int e) {
  Pose xi, xj, z;
  M6 W;
  float huber = -1.f;
  float* aij;
  if (e < p.c) {
    xi = ld_pose(p.poses, e);
    xj = ld_pose(p.poses, e + 1);
    z = ld_pose(p.cz, e);
    W = ld36(p.cW, e);
    aij = w.cAij + 36LL * e;
  } else {
    const int l = e - p.c;
    xi = ld_pose(p.poses, p.li[l]);
    xj = ld_pose(p.poses, p.lj[l]);
    z = ld_pose(p.lz, l);
    W = ld36(p.lW, l);
    huber = p.huber_delta;
    aij = p.Aij + 36LL * l;
  }
  V6 rw;
  M6 Jiw, Jjw;
  linearize_edge(xi, xj, z, W, huber, rw, Jiw, Jjw);
  st36(aij, 0, m6Tmul(Jiw, Jjw));
  float* out = w.blk + 84LL * e;
  st36(out, 0, m6Tmul(Jiw, Jiw));
  st36(out + 36, 0, m6Tmul(Jjw, Jjw));
  st6(out + 72, 0, m6Tvec(Jiw, rw));
  st6(out + 78, 0, m6Tvec(Jjw, rw));
}

__global__ void __launch_bounds__(kThreads) cg6_linearize(Cg6Problem p, Ws w) {
  const int e = blockIdx.x * blockDim.x + threadIdx.x;
  if (e >= p.c + p.El) return;
  linearize_row6(p, w, e);
}

// Node n's payload rows: D = w (Aii[n] + Ajj[n-1]) + loop sum, U = w Aij[n],
// g = w (gi[n] + gj[n-1]) + loop sum (cg_step6.py:135-143, :189-200).
__device__ __noinline__ void assemble_row6(const Cg6Problem& p, const Ws& w, int n) {
  const float wc = p.w_chain;
  {
    M6 U = n < p.c ? ld36(w.cAij, n) : m6zero();
#pragma unroll
    for (int k = 0; k < 36; ++k) U.m[k] *= wc;
    st36(p.payload + 36LL * p.N, n, U);
  }
  M6 D = m6zero();
  V6 g = v6zero();
  if (n < p.c) {  // chain edge n = (n, n+1): node n is its i end
    const float* e = w.blk + 84LL * n;
    D = ld36(e, 0);
    g = ld6(e + 72, 0);
  }
  if (n >= 1 && n - 1 < p.c) {  // chain edge n-1: node n is its j end
    const float* e = w.blk + 84LL * (n - 1);
    m6add(D, ld36(e + 36, 0));
    v6add(g, ld6(e + 78, 0));
  }
#pragma unroll
  for (int k = 0; k < 36; ++k) D.m[k] *= wc;
  v6scale(g, wc);
  M6 Dl = m6zero();
  V6 gl = v6zero();
  for (int q = p.csr_ptr[n]; q < p.csr_ptr[n + 1]; ++q) {
    const int ent = p.csr_ent[q];
    const float* e = w.blk + 84LL * (p.c + (ent >> 1));
    if (ent & 1) {
      m6add(Dl, ld36(e + 36, 0));
      v6add(gl, ld6(e + 78, 0));
    } else {
      m6add(Dl, ld36(e, 0));
      v6add(gl, ld6(e + 72, 0));
    }
  }
  m6add(D, Dl);
  v6add(g, gl);
  st36(p.payload, n, D);
  st6(p.payload + 72LL * p.N, n, g);
}

__global__ void __launch_bounds__(kThreads) cg6_assemble(Cg6Problem p, Ws w) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  assemble_row6(p, w, n);
}

// K7a in one launch (persistent.cuh), K6a's design with SE(3) rows: the
// rows share no reduction, so each stage takes one thread a row over the
// whole launch (for_flat) on CTAs of kRowThreads6 threads in pass_shape's
// shape (one pass over the wider stage's rows: one cluster of at most 16
// CTAs, else a cooperative grid), with a barrier (stage_sync) where the
// staged sequence has a kernel boundary; any shape gives the staged
// launches' values. A linearize row is one thread's long serial chain
// (~3500 operations: the SO(3) log, Jr^-1, Ad, 6x6 products) on scattered
// poses, so the fewer rows an SM runs at once the sooner the stage ends:
// 32-thread CTAs (sphere2500 155, garage 39) beat 64 and 128, and a group
// of 6 threads an edge (scripts/bench_persistent.py part k7a; PERF.md).
constexpr int kRowThreads6 = 32;

// The linearize rows over the E = c + El edges, a barrier, the assemble
// rows over the N nodes -- cg6_linearize and cg6_assemble, row for row; E
// = 0 still runs the assemble stage. w.blk and w.cAij, written in the first
// stage, are read in the second with plain loads.
__global__ void __launch_bounds__(kRowThreads6, 1) cg6_stage_a_persistent(Cg6Problem p, Ws w) {
  for_flat(p.c + p.El, [&](int e) { linearize_row6(p, w, e); });
  stage_sync();
  for_flat(p.N, [&](int n) { assemble_row6(p, w, n); });
}

// ---------------------------------------------------------------------------
// K7b: priors, damping and the PCR factor
// ---------------------------------------------------------------------------

// Row n: D = payload D + Jp^T Jp with r = Log(z^-1 x), J = pW Jr^-1(r), its
// 6 diagonal entries times (1 + lam); b = -(g + Jp^T pW r)
// (cg_step6.py:262-306).
__device__ __noinline__ void setup_row6(const Cg6Problem& p, const float* lam, int n) {
  M6 D = ld36(p.payload, n);
  V6 g = ld6(p.payload + 72LL * p.N, n);
  {
    const V6 rp = se3_log(se3_between(ld_pose(p.pz, n), ld_pose(p.poses, n)));
    const M6 pW = ld36(p.pW, n);
    const M6 Jpw = m6mul(pW, se3_jr_inv(rp));
    m6add(D, m6Tmul(Jpw, Jpw));
    v6add(g, m6Tvec(Jpw, m6vec(pW, rp)));
  }
  const float s = 1.f + lam[0];
#pragma unroll
  for (int i = 0; i < 6; ++i) D.m[7 * i] *= s;
  st36(p.D, n, D);
  v6scale(g, -1.f);
  st6(p.b, n, g);
}

__global__ void __launch_bounds__(kThreads) cg6_setup(Cg6Problem p, const float* lam) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  setup_row6(p, lam, n);
}

// One PCR level (pcr6_factor_row in se3_blocks.cuh), U at level 0 from the
// payload; the last level writes the final inverse instead of D', L', U'.
__global__ void __launch_bounds__(kThreads) cg6_pcr_factor(
    Cg6Problem p, int k, const float* Ds, const float* Us, const float* Ls, float* Dd, float* Ud,
    float* Ld, int last) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  pcr6_factor_row(n, p.N, k, p.eps, Ds, Us, Ls, p.payload + 36LL * p.N, p.A, p.G, p.Dinv, Dd,
                  Ud, Ld, last);
}

// ---------------------------------------------------------------------------
// K7c: one CG pass
// ---------------------------------------------------------------------------

// pHp = s0 + s1; alpha = rz / pHp where pHp > tiny, else 0
// (cg_step6.py:365-369).
__device__ __forceinline__ float step_alpha6(int N, const float* scal, const float* big) {
  const float pHp = scal[1] + big[6LL * N];
  return pHp > kTiny ? scal[0] / fmaxf(pHp, kTiny) : 0.f;
}

// beta = rz_new / rz where rz > tiny, else 0.
__device__ __forceinline__ float step_beta6(float rz_new, const float* scal) {
  const float rz = scal[0];
  return rz > kTiny ? rz_new / fmaxf(rz, kTiny) : 0.f;
}

// x += alpha p; r -= alpha (chain_Ap + tile_Ap) (cg_step6.py:370-373).
__global__ void __launch_bounds__(kThreads) cg6_update(Cg6Problem p, float* x, float* r,
                                                       const float* pv, const float* cap,
                                                       const float* scal, const float* big) {
  const float alpha = step_alpha6(p.N, scal, big);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (n >= p.N) return;
  V6 xn = ld6(x, n), rn = ld6(r, n);
  const V6 pn = ld6(pv, n), cn = ld6(cap, n), tn = ld6(big, n);
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    xn.v[a] += alpha * pn.v[a];
    rn.v[a] -= alpha * (cn.v[a] + tn.v[a]);
  }
  st6(x, n, xn);
  st6(r, n, rn);
}

// One PCR apply level (pcr6_apply_row); the last level also applies Dinv
// and writes the block partials of rdot.out to part.
__global__ void __launch_bounds__(kThreads) cg6_pcr_apply(Cg6Problem p, int k, const float* in,
                                                          float* out, int last,
                                                          const float* rdot, float* part) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float val = 0.f;
  if (n < p.N) {
    const V6 o = pcr6_apply_row(n, p.N, k, p.A, p.G, p.Dinv, in, out, last);
    if (last) val = v6dot(ld6(rdot, n), o);
  }
  if (last) block_sum_to(val, part, blockIdx.x);
}

// rz_new = r.z from the partials; beta; p = z + beta p. rz_new goes to
// scal[2] (scal[0] is still being read).
__global__ void __launch_bounds__(kThreads) cg6_direction(Cg6Problem p, Ws w, float* pv,
                                                          float* scal) {
  const float rz_new = sum_partials(w.part_b, n_blocks(p.N));
  const float beta = step_beta6(rz_new, scal);
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  if (blockIdx.x == 0 && threadIdx.x == 0) scal[2] = rz_new;
  if (n >= p.N) return;
  const V6 z = ld6(w.z, n);
  V6 pn = ld6(pv, n);
#pragma unroll
  for (int a = 0; a < 6; ++a) pn.v[a] = z.v[a] + beta * pn.v[a];
  st6(pv, n, pn);
}

// chain_Ap = D p + U p[n+1] + U[n-1]^T p[n-1] (replicated) and tile_Ap =
// this rank's loop blocks times p through the CSR, into big[0:6N); block
// partials of p.chain_Ap and p.tile_Ap (cg_step6.py:383-437).
__global__ void __launch_bounds__(kThreads) cg6_hvp(Cg6Problem p, Ws w, const float* pv,
                                                    float* cap, float* big) {
  const int n = blockIdx.x * blockDim.x + threadIdx.x;
  float s0 = 0.f, s1 = 0.f;
  if (n < p.N) {
    const float* U = p.payload + 36LL * p.N;
    const V6 vn = ld6(pv, n);
    V6 o = m6vec(ld36(p.D, n), vn);
    if (n + 1 < p.N) v6add(o, m6vec(ld36(U, n), ld6(pv, n + 1)));
    if (n >= 1) v6add(o, m6Tvec(ld36(U, n - 1), ld6(pv, n - 1)));
    st6(cap, n, o);
    s0 = v6dot(vn, o);
    V6 t = v6zero();
    for (int q = p.csr_ptr[n]; q < p.csr_ptr[n + 1]; ++q) {
      const int ent = p.csr_ent[q];
      const int l = ent >> 1;
      const M6 A = ld36(p.Aij, l);
      if (ent & 1) v6add(t, m6Tvec(A, ld6(pv, p.li[l])));  // node is j: A^T p_i
      else v6add(t, m6vec(A, ld6(pv, p.lj[l])));           // node is i: A p_j
    }
    st6(big, n, t);
    s1 = v6dot(vn, t);
  }
  block_sum_to(s0, w.part_a, blockIdx.x);
  __syncthreads();  // thread 0 reads the shared tree before the next sum reuses it
  block_sum_to(s1, w.part_c, blockIdx.x);
}

// One thread: scal = [rz_new, s0, ...] and big[6N] = this rank's s1.
__global__ void cg6_finish(Cg6Problem p, Ws w, float* scal, float* big) {
  const int nb = n_blocks(p.N);
  scal[0] = scal[2];
  scal[1] = sum_in_order(w.part_a, nb);
  big[6LL * p.N] = sum_in_order(w.part_c, nb);
}

// ---------------------------------------------------------------------------
// K7b and K7c as ONE launch each: kWide-thread CTAs in wide_shape's shape,
// K4's wide stages (se3_blocks.cuh), a barrier where the staged sequences
// have a kernel boundary
// ---------------------------------------------------------------------------

// K7b: the setup rows (one thread a row over the launch), then the K PCR
// factor levels on the groups from D and the payload's U -- cg6_setup and
// the K cg6_pcr_factor launches, row for row.
__global__ void __launch_bounds__(kWide, 1) cg6_gn_setup_wide(Cg6Problem p, Ws w,
                                                              const float* lam) {
  for_flat(p.N, [&](int n) { setup_row6(p, lam, n); });
  stage_sync();
  factor6_stages(p.N, p.K, p.eps, p.D, p.payload + 36LL * p.N, w.PD[0], w.PD[1], w.PU[0],
                 w.PU[1], w.PL[0], w.PL[1], p.A, p.G, p.Dinv);
}

// Component a of cg6_hvp's row n (live) on the row's group S (12 floats),
// its two sums kept apart: cap[n][a] = (D p + U p[n+1] + U[n-1]^T p[n-1])[a]
// and big[n][a] = this rank's loop blocks times p, summed from 0.f through
// the CSR, each block's product in m6vec's / m6Tvec's order; the group's
// thread 0 writes p[n].cap[n] to va[n] and p[n].big[n] to vc[n] (v6dot's
// order).
__device__ __forceinline__ void hvp6_split_lane(const Cg6Problem& p, const float* pv, float* cap,
                                                float* big, float* va, float* vc, int n, int a,
                                                bool live, float* S) {
  float o = 0.f, t = 0.f;
  if (live) {
    const float* U = p.payload + 36LL * p.N;
    const float* vn = pv + 6LL * n;
    float s = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) s += p.D[36LL * n + 6 * a + q] * vn[q];
    o = s;
    if (n + 1 < p.N) {
      s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += U[36LL * n + 6 * a + q] * pv[6LL * (n + 1) + q];
      o += s;
    }
    if (n >= 1) {
      s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += U[36LL * (n - 1) + 6 * q + a] * pv[6LL * (n - 1) + q];
      o += s;
    }
    cap[6LL * n + a] = o;
    for (int e = p.csr_ptr[n]; e < p.csr_ptr[n + 1]; ++e) {
      const int ent = p.csr_ent[e];
      const int l = ent >> 1;
      const float* A = p.Aij + 36LL * l;
      s = 0.f;
      if (ent & 1) {  // node is j: A^T p_i
        const float* vi = pv + 6LL * p.li[l];
#pragma unroll
        for (int q = 0; q < 6; ++q) s += A[6 * q + a] * vi[q];
      } else {        // node is i: A p_j
        const float* vj = pv + 6LL * p.lj[l];
#pragma unroll
        for (int q = 0; q < 6; ++q) s += A[6 * a + q] * vj[q];
      }
      t += s;
    }
    big[6LL * n + a] = t;
    S[a] = o;
    S[6 + a] = t;
  }
  __syncwarp();
  if (live && a == 0) {
    const float* vn = pv + 6LL * n;
    float d0 = 0.f, d1 = 0.f;
#pragma unroll
    for (int q = 0; q < 6; ++q) d0 += vn[q] * S[q];
#pragma unroll
    for (int q = 0; q < 6; ++q) d1 += vn[q] * S[6 + q];
    va[n] = d0;
    vc[n] = d1;
  }
  __syncwarp();
}

// K7c: one CG pass -- cg6_update, the K cg6_pcr_apply levels, cg6_direction,
// cg6_hvp and cg6_finish, row for row, with a barrier in place of each
// kernel boundary. Every CTA reads alpha's inputs (scal[0], scal[1],
// big[6N]) before the first barrier and scal[0] before the third; CTA 0
// writes scal[2] at the direction and scal[0], scal[1], big[6N] after the
// last barrier, when every CTA has read them.
__global__ void __launch_bounds__(kWide, 1) cg6_step_wide(Cg6Problem p, Ws w, float* x,
                                                          float* r, float* pv, float* cap,
                                                          float* scal, float* big) {
  const int N = p.N;
  const long long M = 6LL * N;
  const bool lead = blockIdx.x == 0 && threadIdx.x == 0;
  {
    const float alpha = step_alpha6(N, scal, big);
    for_flat(M, [&](int i) {
      x[i] += alpha * pv[i];
      r[i] -= alpha * (cap[i] + big[i]);
    });
  }
  stage_sync();
  apply6_stages(N, p.K, p.A, p.G, p.Dinv, r, w.t[0], w.t[1], w.z, r, w.vb);
  {
    const float rz_new = wide_sum(w.vb, N);
    const float beta = step_beta6(rz_new, scal);
    if (lead) scal[2] = rz_new;
    for_flat(M, [&](int i) { pv[i] = w.z[i] + beta * pv[i]; });
  }
  stage_sync();
  for_groups(N, [&](int n, int a, bool live, float* S) {
    hvp6_split_lane(p, pv, cap, big, w.va, w.vc, n, a, live, S);
  });
  stage_sync();
  if (blockIdx.x == 0) {
    const float s0 = wide_sum(w.va, N);
    const float s1 = wide_sum(w.vc, N);
    if (lead) {
      scal[0] = scal[2];
      scal[1] = s0;
      big[M] = s1;
    }
  }
}

// ---------------------------------------------------------------------------
// Host side: launch sequences
// ---------------------------------------------------------------------------

#define CG6_CHECK()                                 \
  do {                                              \
    const cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

Ws ws_of(const Cg6Problem& p) { return layout(p.N, p.c, p.El, p.ws); }

// K7a's launch shape over n rows: CTAs of kRowThreads6, one pass.
template <typename... KArgs>
cudaError_t row_shape6(void (*kernel)(KArgs...), long long n, Shape& sh) {
  return pass_shape(kernel, kRowThreads6, kRowThreads6, n, sh);
}

}  // namespace

extern "C" {

long long cg6_ws_floats(int N, int c, int El, int K) {
  (void)K;
  return layout(N, c, El, nullptr).total;
}

const char* cg6_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

int cg6_problem_size() { return (int)sizeof(Cg6Problem); }

// K7a: the payload and the Aij stash of this rank at p->poses. One launch of
// cg6_stage_a_persistent in row_shape6's shape over max(N, c + El) rows.
int cg6_stage_a(const Cg6Problem* pp) {
  const Cg6Problem& p = *pp;
  const long long E = (long long)p.c + p.El;
  Shape sh;
  const cudaError_t err = row_shape6(cg6_stage_a_persistent, E > p.N ? E : p.N, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(cg6_stage_a_persistent, sh, kRowThreads6, (cudaStream_t)p.stream,
                                p, ws_of(p));
}

// The same stage as 2 launches (cg6_linearize, cg6_assemble): the staged
// sequence that cg6_stage_a replaced, bitwise equal to it; a yardstick for
// checks and timings, never on the path.
int cg6_stage_a_staged(const Cg6Problem* pp) {
  const Cg6Problem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int E = p.c + p.El;
  if (E > 0) {
    cg6_linearize<<<n_blocks(E), kThreads, 0, s>>>(p, w);
    CG6_CHECK();
  }
  cg6_assemble<<<n_blocks(p.N), kThreads, 0, s>>>(p, w);
  CG6_CHECK();
  return 0;
}

// The CTAs of K7a's launch over n = max(N, c + El) rows, negative where
// they form a cooperative grid rather than one cluster (0: a CUDA error).
int cg6_row_ctas(long long n) {
  Shape sh;
  if (row_shape6(cg6_stage_a_persistent, n, sh) != cudaSuccess) return 0;
  return sh.cooperative ? -sh.ctas : sh.ctas;
}

// The persistent kernels' shape over N rows: CTAs of cg6_step's launch,
// negative where they form a cooperative grid rather than one cluster (0: a
// CUDA error).
int cg6_wide_ctas(int N) {
  Shape sh;
  if (wide_shape(cg6_step_wide, N, sh) != cudaSuccess) return 0;
  return sh.cooperative ? -sh.ctas : sh.ctas;
}

// K7b: D, b and the K-level PCR factor from the all-reduced payload at
// p->poses, damped by (1 + lam[0]) (lam a device pointer). One launch of
// cg6_gn_setup_wide in wide_shape's shape.
int cg6_gn_setup(const Cg6Problem* pp, const float* lam) {
  const Cg6Problem& p = *pp;
  Shape sh;
  const cudaError_t err = wide_shape(cg6_gn_setup_wide, p.N, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(cg6_gn_setup_wide, sh, kWide, (cudaStream_t)p.stream, p,
                                ws_of(p), lam);
}

// The same setup as 1 + K launches (cg6_setup, K cg6_pcr_factor): the
// staged sequence that cg6_gn_setup replaced, bitwise equal to it; a
// yardstick for checks and timings, never on the path.
int cg6_gn_setup_staged(const Cg6Problem* pp, const float* lam) {
  const Cg6Problem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int nb = n_blocks(p.N);
  cg6_setup<<<nb, kThreads, 0, s>>>(p, lam);
  CG6_CHECK();
  for (int k = 0; k < p.K; ++k) {
    const int src = (k - 1) & 1, dst = k & 1;
    const float* Ds = k == 0 ? p.D : w.PD[src];
    const float* Us = k == 0 ? p.payload + 36LL * p.N : w.PU[src];
    const float* Ls = k == 0 ? nullptr : w.PL[src];
    cg6_pcr_factor<<<nb, kThreads, 0, s>>>(p, k, Ds, Us, Ls, w.PD[dst], w.PU[dst], w.PL[dst],
                                           k == p.K - 1);
    CG6_CHECK();
  }
  return 0;
}

// K7c: one CG pass on the carry (x, r, p, chain_Ap (N, 6), scal (4,), big
// (6N+1,) the all-reduced [tile_Ap; s1]), in place; big then holds this
// rank's new [tile_Ap; s1] partial. One launch of cg6_step_wide in
// wide_shape's shape (sphere2500: a 42-CTA cooperative grid).
int cg6_step(const Cg6Problem* pp, float* x, float* r, float* pv, float* cap, float* scal,
             float* big) {
  const Cg6Problem& p = *pp;
  Shape sh;
  const cudaError_t err = wide_shape(cg6_step_wide, p.N, sh);
  if (err != cudaSuccess) return (int)err;
  return (int)launch_persistent(cg6_step_wide, sh, kWide, (cudaStream_t)p.stream, p, ws_of(p),
                                x, r, pv, cap, scal, big);
}

// The same pass as K + 4 launches (cg6_update, K cg6_pcr_apply,
// cg6_direction, cg6_hvp, cg6_finish): the staged sequence that cg6_step
// replaced, bitwise equal to it; a yardstick, never on the path.
int cg6_step_staged(const Cg6Problem* pp, float* x, float* r, float* pv, float* cap,
                    float* scal, float* big) {
  const Cg6Problem& p = *pp;
  const Ws w = ws_of(p);
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int nb = n_blocks(p.N);
  cg6_update<<<nb, kThreads, 0, s>>>(p, x, r, pv, cap, scal, big);
  CG6_CHECK();
  const float* src = r;
  for (int k = 0; k < p.K; ++k) {
    const bool last = k == p.K - 1;
    float* dst = last ? w.z : w.t[k & 1];
    cg6_pcr_apply<<<nb, kThreads, 0, s>>>(p, k, src, dst, last, r, w.part_b);
    CG6_CHECK();
    src = dst;
  }
  cg6_direction<<<nb, kThreads, 0, s>>>(p, w, pv, scal);
  CG6_CHECK();
  cg6_hvp<<<nb, kThreads, 0, s>>>(p, w, pv, cap, big);
  CG6_CHECK();
  cg6_finish<<<1, 1, 0, s>>>(p, w, scal, big);
  CG6_CHECK();
  return 0;
}

}  // extern "C"
