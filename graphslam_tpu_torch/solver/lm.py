"""Gauss-Newton drivers: port of graphslam_tpu/solver/lm.py (GN part).

`_gn_loop(poses0, graph, cfg, mode, iterations)` is the entry point of the
headline solve, called exactly as bench.py calls the JAX one. Modes:

  gn_fused  the whole GN loop in the fused kernel (ops/gn_kernel.py): the
            hand-written CUDA kernel for CUDA tensors, its plain torch twin
            for CPU tensors
  pcg       linearize + build_blocks + pcg_solve + retract, plain torch
  dense     the same with dense_solve
  auto      dense up to cfg.dense_threshold poses, else pcg

`lm_solve`/`_lm_loop` (and the LM mode of the fused kernel) and
"pcg_fused" (the K3 kernel) are not ported yet; see ROADMAP.md.
"""

from __future__ import annotations

import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.factors.linearize import group_for, linearize
from graphslam_tpu_torch.solver.normal_eq import build_blocks, dense_solve, pcg_solve


def _solve_mode(cfg: SolverConfig, num_poses: int) -> str:
    if cfg.mode == "auto":
        return "dense" if num_poses <= cfg.dense_threshold else "pcg"
    return cfg.mode


def _retract_all(poses: torch.Tensor, dx: torch.Tensor) -> torch.Tensor:
    return group_for(dx.shape[-1]).retract(poses, dx)


def _gn_loop(
    poses0: torch.Tensor, graph: FactorGraph, cfg: SolverConfig, mode: str, iterations: int
) -> torch.Tensor:
    """`iterations` Gauss-Newton steps from poses0; returns the poses."""
    group_for(graph.tangent_dim)
    if mode == "gn_fused":
        from graphslam_tpu_torch.ops.gn_kernel import fused_gn_solve

        return fused_gn_solve(
            poses0, graph,
            iterations=iterations,
            cg_iters=cfg.cg_max_iterations,
            pcr_levels=cfg.pcr_levels,
            edge_tile=cfg.edge_tile,
            hvp_splits=cfg.hvp_splits,
            warm_start=cfg.cg_warm_start,
        )
    if mode not in ("pcg", "dense"):
        raise NotImplementedError(
            f"mode {mode!r} is not ported yet (ROADMAP.md: 'pcg_fused' is the K3 kernel)"
        )

    poses = poses0
    lam = torch.zeros((), dtype=poses0.dtype, device=poses0.device)
    for _ in range(iterations):
        lin = linearize(poses, graph)
        sys = build_blocks(lin, graph, poses.shape[0])
        if mode == "dense":
            dx = dense_solve(sys, lam)
        else:
            dx = pcg_solve(
                sys, lam,
                max_iters=cfg.cg_max_iterations,
                tol=cfg.cg_tol,
                preconditioner=cfg.preconditioner,
                chain_prefix=graph.chain_prefix,
            )
        poses = _retract_all(poses, dx)
    return poses


def gn_solve(
    poses0: torch.Tensor,
    graph: FactorGraph,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 10,
) -> torch.Tensor:
    """Plain Gauss-Newton, fixed iteration count (BASELINE config 1)."""
    return _gn_loop(poses0, graph, cfg, _solve_mode(cfg, poses0.shape[0]), iterations)
