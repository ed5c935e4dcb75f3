"""Distributed SE(2) Gauss-Newton / LM with the fused kernel's mathematics.

Port of graphslam_tpu/parallel/dist_fused.py. The same GN/LM as the fused
GN kernel (ops/gn_kernel.py: its linearization, PCR-factored chain
preconditioner, fixed-count guarded CG and retraction), decomposed into
per-rank SPMD stages on torch.distributed (parallel/dist.py's Mesh):

  * Loop edges are SHARDED: they are cut into tiles of `edge_tile` edges,
    the tile count is padded to a multiple of the world size and rank d owns
    tiles [d * tiles_per_dev, (d + 1) * tiles_per_dev) (dist_fused.py:
    766-794), so each edge is linearized, summed and multiplied by exactly
    one rank. The tiles themselves are a TPU layout and go no further.
  * The odometry chain, priors, damping, the PCR preconditioner, CG vectors
    and scalars, retraction and the LM decision are replicated: computed
    identically on every rank.
  * With `cg_kernel` (the main path on the card) each GN iteration is K6a,
    ONE all-reduce of the normal-equation payload, K6b, then cg_iters + 1
    passes of [K6c, ONE all-reduce of [tile_Ap; s1]]; the first pass is the
    CG prologue (parallel/cg_step.py). The chain is linearized on every
    rank and weighted by w_chain = [rank == 0], so the all-reduce counts it
    once.
  * Without it (the plain path, the JAX package's XLA loop): the chain is
    linearized by node blocks, one per rank, and combined with the loop sums
    in one all-reduce; CG runs in torch with one all-reduce per H@p. Where
    the halo fits, the PCR factor, its application and the chain H@p run
    per rank on its node block plus a halo of 2^(K+1) nodes, with one more
    all-reduce of z per CG iteration (the slab-PCR branch, :534-565).

`cg_kernel=None` takes the kernels for CUDA tensors and the plain path for
CPU tensors; `cg_kernel=True` on the CPU runs the kernels' plain twins in
the kernel path's order. A kernel that fails to build or launch raises.
Page-windowed graphs (ops/bucketize.py, a TPU one-hot MXU device) are not
ported: a graph with page_window > 0 raises.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops.pcg_kernel import pcr_apply_reference, pcr_levels_for
from graphslam_tpu_torch.parallel import cg_step as cs
from graphslam_tpu_torch.parallel.dist import Mesh


def _ceil_div(a: int, b: int) -> int:
    return -(-a // b)


def _prepare(poses0, graph: FactorGraph, mesh: Mesh, huber_delta: float,
             pcr_levels: Optional[int], edge_tile: int) -> cs.Shard:
    """This rank's Shard: N, K = min(ceil(log2 N), pcr_levels), the chain
    and priors, and the loop edges of this rank's tiles (dist_fused.py:
    726-794)."""
    N, T = poses0.shape
    if T != 3 or graph.tangent_dim != 3:
        raise ValueError("dist_fused supports T=3 (SE2) only")
    return shard_of(poses0, graph, mesh, huber_delta, pcr_levels, edge_tile, gk.pack_graph,
                    cs.make_shard)


def shard_of(poses0, graph, mesh: Mesh, huber_delta: float, pcr_levels: Optional[int],
             edge_tile: int, pack, make_shard):
    """The Shard that `make_shard` builds from `pack`(graph, N): the loop
    edges are cut into tiles of `edge_tile`, the tile count is padded to a
    multiple of the world size and this rank takes its run of tiles."""
    N = poses0.shape[0]
    if getattr(graph, "page_window", 0):
        raise ValueError("page-windowed graphs (ops/bucketize.py) are not ported: the port "
                         "gathers loop edges by index and runs page_window = 0 only")
    if poses0.device != mesh.device or graph.device != mesh.device:
        raise ValueError(f"poses on {poses0.device} and graph on {graph.device}, "
                         f"but the mesh holds its tensors on {mesh.device}")
    pk = pack(graph, N)
    tile = int(edge_tile)
    n_tiles = _ceil_div(pk.El, tile)
    tiles_per_dev = _ceil_div(max(n_tiles, 1), mesh.size)
    lo = min(mesh.rank * tiles_per_dev * tile, pk.El)
    hi = min((mesh.rank + 1) * tiles_per_dev * tile, pk.El)
    return make_shard(pk, lo, hi, pcr_levels_for(N, pcr_levels),
                      1.0 if mesh.rank == 0 else 0.0, huber_delta)


def _chain_block(sh: cs.Shard, mesh: Mesh):
    """[lo, hi): the nodes whose chain edges (and, slab-PCR, whose
    preconditioner rows) this rank computes on the plain path."""
    per = _ceil_div(sh.N, mesh.size)
    return min(mesh.rank * per, sh.N), min((mesh.rank + 1) * per, sh.N)


def _prior_rows(poses, sh: cs.Shard):
    """The whitened prior residuals R Log(z^-1 x) of every node."""
    return gk._mv(sh.prior_R, gk._log(gk._between(sh.prior_z, poses)))


def chi2(poses, sh: cs.Shard, mesh: Mesh, residual=gk._residual, prior_rows=_prior_rows):
    """The robustified cost (dist_fused.py:319-362): this rank's chain block
    and loop edges (Huber rho when huber_delta > 0), one all-reduce, plus
    the replicated prior squares. `residual` and `prior_rows` are the SE(2)
    ones; parallel/dist_fused6.py passes the SE(3) ones."""
    lo, hi = _chain_block(sh, mesh)
    hi = min(hi, sh.c)
    e = torch.zeros((), dtype=poses.dtype, device=poses.device)
    if hi > lo:
        rw = residual(poses[lo:hi], poses[lo + 1: hi + 1], sh.chain_z[lo:hi], sh.chain_R[lo:hi])
        e = e + torch.sum(rw * rw)
    if sh.El:
        rw = residual(poses[sh.loop_i.long()], poses[sh.loop_j.long()], sh.loop_z, sh.loop_R)
        et = torch.sum(rw * rw, -1)
        if sh.huber_delta > 0.0:
            d = sh.huber_delta
            n = torch.sqrt(torch.clamp(et, min=1e-24))
            et = torch.where(n <= d, et, 2.0 * d * n - d * d)
        e = e + torch.sum(et)
    e = mesh.all_reduce(e.reshape(1))[0]
    rp = prior_rows(poses, sh)
    return e + torch.sum(rp * rp)


def solve_dx_kernels(poses, lam, sh: cs.Shard, mesh: Mesh, cg_iters: int, stage_a, gn_setup,
                     cg_step):
    """The kernel path's inner solve (dist_fused.py:364-423): stage_a (K6a,
    or K7a from parallel/dist_fused6.py), one all-reduce, gn_setup, then
    cg_iters + 1 passes of cg_step, each followed by one all-reduce. The
    carry is made and checked once (`cg_step.new_carry`)."""
    payload, Aij = stage_a(sh, poses)
    mesh.all_reduce(payload)
    st = gn_setup(sh, payload, poses, lam)
    carry = cs.new_carry(sh, st.b)
    for _ in range(cg_iters + 1):
        cg_step(sh, st, Aij, carry)
        mesh.all_reduce(carry.big)
    return carry.x


def _solve_dx_plain(poses, lam, sh: cs.Shard, mesh: Mesh, cg_iters: int):
    """The plain path's inner solve, the JAX package's XLA loop
    (dist_fused.py:425-660)."""
    N, K = sh.N, sh.K
    lo, hi = _chain_block(sh, mesh)
    Dc, Uc, gc = cs.chain_blocks(poses, sh, lo, hi)
    Dl, gl, Aij = cs.loop_blocks(poses, sh)
    big = mesh.all_reduce(torch.cat([t.reshape(-1) for t in (Dc, Uc, gc, Dl, gl)]))
    Dc, Uc, gc, Dl, gl = torch.split(big, [9 * N, 9 * N, 3 * N, 9 * N, 3 * N])
    Ap, gp = cs.prior_blocks(poses, sh)
    D = gk._damp(Dc.view(N, 3, 3) + Dl.view(N, 3, 3) + Ap, lam[0])
    U = Uc.view(N, 3, 3)
    b = -(gc.view(N, 3) + gl.view(N, 3) + gp)

    H = 2 << K
    slab = mesh.size > 1 and (hi - lo) + 2 * H <= N and H < N
    if slab:
        # factor, apply and chain H@v on this rank's block plus a halo: the
        # block's rows are exact, the halo's are discarded
        wlo, whi = max(0, lo - H), min(N, hi + H)
        Dw, Uw = D[wlo:whi], U[wlo:whi]
        A, G, Dinv = gk.pcr_factor_reference(Dw, Uw, K)

        def embed(rows):
            out = torch.zeros((N, 3), dtype=rows.dtype, device=rows.device)
            out[lo:hi] = rows[lo - wlo: hi - wlo]
            return out

        def apply_z(r):
            return mesh.all_reduce(embed(pcr_apply_reference(A, G, Dinv, r[wlo:whi])))

        def hvp(v):
            base = embed(cs.chain_hvp(Dw, Uw, v[wlo:whi]))
            return mesh.all_reduce(base + cs.loop_hvp(sh, Aij, v))
    else:
        A, G, Dinv = gk.pcr_factor_reference(D, U, K)

        def apply_z(r):
            return pcr_apply_reference(A, G, Dinv, r)

        def hvp(v):
            return cs.chain_hvp(D, U, v) + mesh.all_reduce(cs.loop_hvp(sh, Aij, v))

    return pcg(b, apply_z, hvp, cg_iters)


def pcg(b, apply_z, hvp, cg_iters: int):
    """cg_iters guarded CG iterations on H x = b from x = 0, with the
    preconditioner apply_z (the XLA loop's CG, dist_fused.py:632-660)."""
    tiny = torch.tensor(gk._TINY, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    r = b
    z = apply_z(r)
    p = z
    rz = torch.sum(r * z)
    x = torch.zeros_like(b)
    for _ in range(cg_iters):
        Hp = hvp(p)
        pHp = torch.sum(p * Hp)
        # Krylov-exhaustion guard: freeze the update once pHp <= tiny
        alpha = torch.where(pHp > tiny, rz / torch.maximum(pHp, tiny), zero)
        x = x + alpha * p
        r = r - alpha * Hp
        z = apply_z(r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > tiny, rz_new / torch.maximum(rz, tiny), zero)
        p = z + beta * p
        rz = rz_new
    return x


def iterate(poses0, solve_dx, chi2_of, retract, iterations: int, lm: bool, lam0: float,
            lam_factor: float, lam_min: float, lam_max: float):
    """GN (lm False) or LM iterations of x <- retract(x, solve_dx(x, lam)):
    LM accepts a candidate whose chi2_of is lower, with the lambda schedule
    (dist_fused.py:676-699), all on the device. Returns (poses, None) or
    (poses, (chi2, lambda, accepted_steps))."""
    dtype, dev = poses0.dtype, poses0.device
    poses = poses0
    if not lm:
        lam = torch.zeros(1, dtype=dtype, device=dev)
        for _ in range(iterations):
            poses = retract(poses, solve_dx(poses, lam))
        return poses, None
    lam = torch.full((1,), lam0, dtype=dtype, device=dev)
    err = chi2_of(poses)
    n_acc = torch.zeros((), dtype=dtype, device=dev)
    for _ in range(iterations):
        cand = retract(poses, solve_dx(poses, lam))
        new_err = chi2_of(cand)
        accepted = new_err < err
        poses = torch.where(accepted, cand, poses)
        lam = torch.where(accepted, torch.clamp(lam / lam_factor, min=lam_min),
                          torch.clamp(lam * lam_factor, max=lam_max))
        err = torch.where(accepted, new_err, err)
        n_acc = n_acc + accepted.to(dtype)
    return poses, (err, lam[0], n_acc)


def _dist_fused(poses0, graph: FactorGraph, mesh: Mesh, iterations: int, cg_iters: int,
                huber_delta: float, pcr_levels: Optional[int], edge_tile: int, lm: bool,
                lam0: float, lam_factor: float, lam_min: float, lam_max: float,
                cg_kernel: Optional[bool]):
    sh = _prepare(poses0, graph, mesh, huber_delta, pcr_levels, edge_tile)
    if cg_kernel is None:
        cg_kernel = poses0.device.type == "cuda"
    if cg_kernel:
        def solve(p, lam):
            return solve_dx_kernels(p, lam, sh, mesh, cg_iters, cs.stage_a, cs.gn_setup,
                                    cs.cg_step)
    else:
        def solve(p, lam):
            return _solve_dx_plain(p, lam, sh, mesh, cg_iters)
    return iterate(poses0, solve, lambda p: chi2(p, sh, mesh), gk.retract_reference, iterations,
                   lm, lam0, lam_factor, lam_min, lam_max)


def dist_fused_gn_solve(
    poses0: torch.Tensor,
    graph: FactorGraph,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 10,
    axis: str = "dev",
    cg_kernel: Optional[bool] = None,
):
    """`iterations` full GN iterations of the fused-kernel math, SPMD over
    `mesh`: sharded loop edges, one all-reduce per CG iteration. Every rank
    passes the whole graph and the same poses, on the mesh's device, and
    gets the same (N, 3) poses back. cg_kernel runs each stage as the
    hand-written kernels K6a-c (parallel/cg_step.py); None = on for CUDA
    tensors. cfg.hvp_splits (bf16 splits on the TPU) is accepted and
    ignored: the port multiplies in float32."""
    out, _ = _dist_fused(
        poses0, graph, mesh, iterations, cfg.cg_max_iterations, -1.0, cfg.pcr_levels,
        cfg.edge_tile, False, cfg.init_lambda, cfg.lambda_factor, cfg.min_lambda,
        cfg.max_lambda, cg_kernel,
    )
    return out


def dist_fused_lm_solve(
    poses0: torch.Tensor,
    graph: FactorGraph,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 30,
    axis: str = "dev",
    cg_kernel: Optional[bool] = None,
):
    """Distributed LM (damped solve, all-reduced candidate cost, accept/
    reject and lambda schedule replicated, no host read). Returns (poses,
    (chi2, lambda, accepted_steps)), the last three () tensors."""
    return _dist_fused(
        poses0, graph, mesh, iterations, cfg.cg_max_iterations,
        cfg.huber_delta if cfg.use_huber_on_loops else -1.0, cfg.pcr_levels, cfg.edge_tile,
        True, cfg.init_lambda, cfg.lambda_factor, cfg.min_lambda, cfg.max_lambda, cg_kernel,
    )
