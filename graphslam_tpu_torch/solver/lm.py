"""Gauss-Newton / Levenberg-Marquardt loops: port of graphslam_tpu/solver/lm.py.

`lm_solve` is the one call the reference backend exists to make,
gtsam::LevenbergMarquardtOptimizer(graph, initial).optimize() (graph.cpp:119,
SURVEY.md §3.3). `_gn_loop(poses0, graph, cfg, mode, iterations)` is the
entry point of the headline GN solve, called exactly as bench.py calls the
JAX one. Modes:

  gn_fused   the whole GN (or, in lm_solve, LM) loop in the fused kernel
             (ops/gn_kernel.py for SE(2), ops/gn6_kernel.py for SE(3)): the
             hand-written CUDA kernel for CUDA tensors, its plain torch twin
             for CPU tensors
  pcg_fused  linearize + build_blocks + the fused PCR-preconditioned CG
             (ops/pcg_kernel.py, K3; ops/pcg6_kernel.py, K5) + retract
  pcg        linearize + build_blocks + pcg_solve + retract, plain torch
  dense      the same with dense_solve
  auto       dense up to cfg.dense_threshold poses, else pcg

SE(2) graphs carry (N, 3) poses and SE(3) graphs (N, 12); the kernel of
each fused mode is picked by the graph's tangent dimension.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.factors.linearize import chi2, group_for, linearize
from graphslam_tpu_torch.geometry import se3
from graphslam_tpu_torch.solver.normal_eq import build_blocks, dense_solve, pcg_solve


class LMState(NamedTuple):
    poses: torch.Tensor
    lam: torch.Tensor
    error: torch.Tensor
    iterations: torch.Tensor
    converged: torch.Tensor


def _solve_mode(cfg: SolverConfig, num_poses: int) -> str:
    if cfg.mode == "auto":
        return "dense" if num_poses <= cfg.dense_threshold else "pcg"
    return cfg.mode


def _fused_pcg(sys, lam, cfg: SolverConfig, graph: FactorGraph, use_kernel: bool = True):
    """The fused whole-CG-loop solve of an assembled system, K3 for SE(2)
    and K5 for SE(3). use_kernel=False takes the plain twin on any device."""
    if graph.tangent_dim == 3:
        from graphslam_tpu_torch.ops import pcg_kernel as m

        f = m.fused_pcg_solve if use_kernel else m.fused_pcg_solve_reference
    else:
        from graphslam_tpu_torch.ops import pcg6_kernel as m

        f = m.fused_pcg6_solve if use_kernel else m.fused_pcg6_solve_reference
    return f(sys, lam, max_iters=cfg.cg_max_iterations, chain_prefix=graph.chain_prefix)


def _retract_all(poses: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    out = group_for(dx.shape[-1]).retract(poses, dx)
    if poses.shape[-1] == 12:
        out = se3.renormalize(out)
    return out


def _linearized_system(poses, graph: FactorGraph, cfg: SolverConfig):
    lin = linearize(poses, graph, huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops)
    return build_blocks(lin, graph, poses.shape[0])


def _damped_solve(sys, lam, cfg: SolverConfig, graph: FactorGraph, mode: str,
                  use_kernel: bool = True):
    if mode == "dense":
        return dense_solve(sys, lam)
    if mode == "pcg_fused":
        return _fused_pcg(sys, lam, cfg, graph, use_kernel)
    if mode == "pcg":
        return pcg_solve(
            sys, lam,
            max_iters=cfg.cg_max_iterations,
            tol=cfg.cg_tol,
            preconditioner=cfg.preconditioner,
            chain_prefix=graph.chain_prefix,
        )
    raise ValueError(f"unknown solver mode {mode!r}")


def _lm_loop(poses0: torch.Tensor, graph: FactorGraph, cfg: SolverConfig, mode: str) -> LMState:
    """Levenberg-Marquardt with the classic lambda schedule, up to
    cfg.max_iterations iterations, stopping once converged.

    Each iteration: damped solve, candidate, its chi2 (Huber on loop edges
    when cfg.use_huber_on_loops), accept or reject. After a rejected step
    the poses have not moved, so the linearization is reused. Those two
    decisions are the loop's only host reads: ONE read per LM iteration,
    of a (2,) tensor [accepted, converged]; everything else stays on the
    device. "gn_fused" maps to "pcg_fused" here, as in the JAX package
    (lm_solve sends gn_fused to the fused LM kernel instead).
    """
    if mode == "gn_fused":
        mode = "pcg_fused"
    hub = dict(huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops)
    dtype, dev = poses0.dtype, poses0.device
    poses = poses0
    err = chi2(poses0, graph, **hub)
    lam = torch.tensor(cfg.init_lambda, dtype=dtype, device=dev)
    iterations = torch.zeros((), dtype=torch.int32, device=dev)
    converged = torch.zeros((), dtype=torch.bool, device=dev)
    sys = _linearized_system(poses0, graph, cfg)
    need_relin = False
    for _ in range(cfg.max_iterations):
        if need_relin:
            sys = _linearized_system(poses, graph, cfg)
        dx = _damped_solve(sys, lam, cfg, graph, mode)
        candidate = _retract_all(poses, dx)
        new_err = chi2(candidate, graph, **hub)
        accepted = new_err < err
        poses = torch.where(accepted, candidate, poses)
        decrease = err - new_err
        converged = accepted & (
            (decrease < cfg.abs_decrease_tol) | (decrease < cfg.rel_decrease_tol * err)
        )
        converged = converged | (lam >= cfg.max_lambda)
        lam = torch.where(
            accepted,
            torch.clamp(lam / cfg.lambda_factor, min=cfg.min_lambda),
            torch.clamp(lam * cfg.lambda_factor, max=cfg.max_lambda),
        )
        err = torch.where(accepted, new_err, err)
        iterations = iterations + 1
        need_relin, stop = torch.stack([accepted, converged]).tolist()
        if stop:
            break
    return LMState(poses=poses, lam=lam, error=err, iterations=iterations, converged=converged)


def auto_init_poses(poses0: torch.Tensor, graph: FactorGraph) -> torch.Tensor:
    """Chordal bootstrap, applied only when needed.

    If the whitened chi2 at `poses0` is catastrophically above the
    statistical expectation (> 100x the active residual dimension, a
    hopeless basin), run chordal initialization (solver/init.py) and keep
    whichever start has the lower chi2. One host read decides.
    """
    from graphslam_tpu_torch.solver.init import chordal_init_se2, chordal_init_se3

    T = graph.tangent_dim
    m = T * (graph.edge_mask.sum() + graph.prior_mask.sum()).to(poses0.dtype)
    e0 = chi2(poses0, graph)
    if not bool(e0 > 100.0 * m):
        return poses0
    init_fn = chordal_init_se2 if T == 3 else chordal_init_se3
    cand = init_fn(graph, poses0.shape[0])
    return torch.where(chi2(cand, graph) < e0, cand, poses0)


def lm_solve(
    poses0: torch.Tensor,
    graph: FactorGraph,
    cfg: SolverConfig = SolverConfig(),
    auto_init: bool = False,
) -> LMState:
    """Full Levenberg-Marquardt optimization. Returns the final LMState.

    Mode gn_fused runs the whole LM loop in the fused kernel's LM mode
    (`fused_lm_solve`; `fused_lm6_solve` on SE(3) graphs): cfg.max_iterations
    steps with no early exit, and `iterations` counts the ACCEPTED steps.
    Every other mode runs `_lm_loop`, where `iterations` counts the loop's
    iterations. auto_init bootstraps a hopeless start with chordal
    initialization first (`auto_init_poses`).
    """
    if auto_init:
        poses0 = auto_init_poses(poses0, graph)
    mode = _solve_mode(cfg, poses0.shape[0])
    if mode == "gn_fused":
        if graph.tangent_dim == 3:
            from graphslam_tpu_torch.ops.gn_kernel import fused_lm_solve
        else:
            from graphslam_tpu_torch.ops.gn6_kernel import fused_lm6_solve as fused_lm_solve

        poses, err, lam, n_acc, conv = fused_lm_solve(
            poses0, graph,
            iterations=cfg.max_iterations,
            cg_iters=cfg.cg_max_iterations,
            huber_delta=cfg.huber_delta if cfg.use_huber_on_loops else -1.0,
            lam0=cfg.init_lambda,
            lam_factor=cfg.lambda_factor,
            lam_min=cfg.min_lambda,
            lam_max=cfg.max_lambda,
            pcr_levels=cfg.pcr_levels,
            edge_tile=cfg.edge_tile,
            hvp_splits=cfg.hvp_splits,
            abs_tol=cfg.abs_decrease_tol,
            rel_tol=cfg.rel_decrease_tol,
        )
        return LMState(poses=poses, lam=lam, error=err, iterations=n_acc.to(torch.int32),
                       converged=conv.to(torch.bool))
    return _lm_loop(poses0, graph, cfg, mode)


def _gn_loop(
    poses0: torch.Tensor, graph: FactorGraph, cfg: SolverConfig, mode: str, iterations: int,
    use_kernel: bool = True,
) -> torch.Tensor:
    """`iterations` Gauss-Newton steps from poses0; returns the poses.
    use_kernel=False runs the fused modes' plain twins on any device."""
    group_for(graph.tangent_dim)
    if mode == "gn_fused":
        if graph.tangent_dim == 3:
            from graphslam_tpu_torch.ops import gn_kernel as m

            f = m.fused_gn_solve if use_kernel else m.fused_gn_solve_reference
        else:
            from graphslam_tpu_torch.ops import gn6_kernel as m

            f = m.fused_gn6_solve if use_kernel else m.fused_gn6_solve_reference
        return f(
            poses0, graph,
            iterations=iterations,
            cg_iters=cfg.cg_max_iterations,
            pcr_levels=cfg.pcr_levels,
            edge_tile=cfg.edge_tile,
            hvp_splits=cfg.hvp_splits,
            warm_start=cfg.cg_warm_start,
        )
    poses = poses0
    lam = torch.zeros((), dtype=poses0.dtype, device=poses0.device)
    for _ in range(iterations):
        lin = linearize(poses, graph)
        sys = build_blocks(lin, graph, poses.shape[0])
        poses = _retract_all(poses, _damped_solve(sys, lam, cfg, graph, mode, use_kernel))
    return poses


def gn_solve(
    poses0: torch.Tensor,
    graph: FactorGraph,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 10,
) -> torch.Tensor:
    """Plain Gauss-Newton, fixed iteration count (BASELINE config 1)."""
    return _gn_loop(poses0, graph, cfg, _solve_mode(cfg, poses0.shape[0]), iterations)
