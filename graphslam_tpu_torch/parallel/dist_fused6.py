"""Distributed SE(3) Gauss-Newton / LM with the fused SE(3) kernel's mathematics.

Port of graphslam_tpu/parallel/dist_fused6.py, the SE(3) companion of
parallel/dist_fused.py: the GN/LM of the fused SE(3) kernel
(ops/gn6_kernel.py: its linearization, PCR-factored chain preconditioner,
fixed-count guarded CG and renormalizing retraction), decomposed into
per-rank SPMD stages on torch.distributed (parallel/dist.py's Mesh):

  * Loop edges are SHARDED in tiles of `edge_tile` edges, the tile count
    padded to a multiple of the world size (dist_fused6.py:583-594), so each
    edge is linearized, summed and multiplied by exactly one rank.
  * The odometry chain, priors, damping, the PCR preconditioner, CG vectors
    and scalars, retraction and the LM decision are replicated.
  * With `cg_kernel` (the main path on the card) each GN iteration is K7a,
    ONE all-reduce of the normal-equation payload, K7b, then cg_iters + 1
    passes of [K7c, ONE all-reduce of [tile_Ap; s1]]; the first pass is the
    CG prologue (parallel/cg_step6.py, dist_fused6.py:243-289). The chain
    is linearized on every rank and weighted by w_chain = [rank == 0], so
    the all-reduce counts it once.
  * Without it (the plain path, the JAX package's XLA loop, :290-477): the
    chain is linearized by node blocks, one per rank, and combined with the
    loop sums in one all-reduce; priors, damping and the PCR factor are
    replicated (the SE(3) module has no slab-PCR branch); CG runs in torch
    with one all-reduce per H@p.

`cg_kernel=None` takes the kernels for CUDA tensors and the plain path for
CPU tensors; `cg_kernel=True` on the CPU runs the kernels' plain twins in
the kernel path's order. A kernel that fails to build or launch raises.
Page-windowed graphs (ops/bucketize.py, a TPU one-hot MXU device) are not
ported: a graph with page_window > 0 raises. cfg.hvp_splits (bf16 splits on
the TPU) is accepted and ignored: the port multiplies in float32.
"""

from __future__ import annotations

from typing import Optional

import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.geometry import se3
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops import gn6_kernel as g6
from graphslam_tpu_torch.ops.pcg_kernel import pcr_apply_reference
from graphslam_tpu_torch.parallel import cg_step as cs
from graphslam_tpu_torch.parallel import cg_step6 as cs6
from graphslam_tpu_torch.parallel import dist_fused as df
from graphslam_tpu_torch.parallel.dist import Mesh


def _prepare6(poses0, graph: FactorGraph, mesh: Mesh, huber_delta: float,
              pcr_levels: Optional[int], edge_tile: int) -> cs6.Shard6:
    """This rank's Shard6: N, K = min(ceil(log2 N), pcr_levels), the chain
    and priors, and the loop edges of this rank's tiles (dist_fused6.py:
    541-616)."""
    N, T = poses0.shape
    if T != 12 or graph.tangent_dim != 6:
        raise ValueError("dist_fused6 expects (N, 12) SE(3) poses")
    return df.shard_of(poses0, graph, mesh, huber_delta, pcr_levels, edge_tile, g6.pack_graph6,
                       cs6.make_shard6)


def _prior_rows6(poses, sh: cs6.Shard6):
    """The whitened prior residuals W Log(z^-1 x) of every node."""
    return g6._mv(sh.prior_R, se3.log(se3.between(sh.prior_z, poses)))


def _solve_dx_plain6(poses, lam, sh: cs6.Shard6, mesh: Mesh, cg_iters: int):
    """The plain path's inner solve, the JAX package's XLA loop
    (dist_fused6.py:290-477)."""
    N = sh.N
    lo, hi = df._chain_block(sh, mesh)
    Dc, Uc, gc = cs.chain_blocks(poses, sh, lo, hi)
    Dl, gl, Aij = cs.loop_blocks(poses, sh)
    big = mesh.all_reduce(torch.cat([t.reshape(-1) for t in (Dc, Uc, gc, Dl, gl)]))
    Dc, Uc, gc, Dl, gl = torch.split(big, [36 * N, 36 * N, 6 * N, 36 * N, 6 * N])
    Ap, gp = cs6.prior_blocks6(poses, sh)
    D = gk._damp(Dc.view(N, 6, 6) + Dl.view(N, 6, 6) + Ap, lam[0])
    U = Uc.view(N, 6, 6)
    b = -(gc.view(N, 6) + gl.view(N, 6) + gp)
    A, G, Dinv = g6.pcr_factor_reference6(D, U, sh.K)

    def hvp(v):
        return cs.chain_hvp(D, U, v) + mesh.all_reduce(cs.loop_hvp(sh, Aij, v))

    return df.pcg(b, lambda r: pcr_apply_reference(A, G, Dinv, r), hvp, cg_iters)


def _dist_fused6(poses0, graph: FactorGraph, mesh: Mesh, iterations: int, cg_iters: int,
                 huber_delta: float, pcr_levels: Optional[int], edge_tile: int, lm: bool,
                 lam0: float, lam_factor: float, lam_min: float, lam_max: float,
                 cg_kernel: Optional[bool]):
    sh = _prepare6(poses0, graph, mesh, huber_delta, pcr_levels, edge_tile)
    if cg_kernel is None:
        cg_kernel = poses0.device.type == "cuda"
    if cg_kernel:
        def solve(p, lam):
            return df.solve_dx_kernels(p, lam, sh, mesh, cg_iters, cs6.stage_a6, cs6.gn_setup6,
                                       cs6.cg_step6)
    else:
        def solve(p, lam):
            return _solve_dx_plain6(p, lam, sh, mesh, cg_iters)
    return df.iterate(poses0, solve, lambda p: df.chi2(p, sh, mesh, g6._residual6, _prior_rows6),
                      g6.retract_reference6, iterations, lm, lam0, lam_factor, lam_min, lam_max)


def dist_fused6_gn_solve(
    poses0: torch.Tensor,
    graph: FactorGraph,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 10,
    axis: str = "dev",
    cg_kernel: Optional[bool] = None,
):
    """`iterations` full SE(3) GN iterations of the fused-kernel math, SPMD
    over `mesh`: sharded loop edges, one all-reduce per CG iteration. Every
    rank passes the whole graph and the same (N, 12) poses, on the mesh's
    device, and gets the same (N, 12) poses back. cg_kernel runs each stage
    as the hand-written kernels K7a-c (parallel/cg_step6.py); None = on for
    CUDA tensors."""
    out, _ = _dist_fused6(
        poses0, graph, mesh, iterations, cfg.cg_max_iterations, -1.0, cfg.pcr_levels,
        cfg.edge_tile, False, cfg.init_lambda, cfg.lambda_factor, cfg.min_lambda,
        cfg.max_lambda, cg_kernel,
    )
    return out


def dist_fused6_lm_solve(
    poses0: torch.Tensor,
    graph: FactorGraph,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 30,
    axis: str = "dev",
    cg_kernel: Optional[bool] = None,
):
    """Distributed SE(3) LM (damped solve, all-reduced candidate cost,
    accept/reject and lambda schedule replicated, no host read). Returns
    (poses, (chi2, lambda, accepted_steps)), the last three () tensors."""
    return _dist_fused6(
        poses0, graph, mesh, iterations, cfg.cg_max_iterations,
        cfg.huber_delta if cfg.use_huber_on_loops else -1.0, cfg.pcr_levels, cfg.edge_tile,
        True, cfg.init_lambda, cfg.lambda_factor, cfg.min_lambda, cfg.max_lambda, cg_kernel,
    )
