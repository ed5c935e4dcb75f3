"""Marginal covariance recovery (gtsam::Marginals::marginalCovariance):
port of graphslam_tpu/solver/marginals.py, dense path only.

The dense path inverts the assembled Hessian; the JAX package does that
outside any Pallas kernel, so here it is a library call
(torch.linalg.inv_ex, which checks no error flag and so never waits for the
device). The float32 Hessian is inverted in float64: on online maps its
condition number reaches ~1e8, where a float32 inverse is off by a few
1e-3 of the largest entry (the JAX package's by 2.9%,
scripts/port_precision_report.py). The selected-inverse + Woodbury path (marginal_covariances_all)
and the per-pose CG path (marginal_covariance_cg) are not ported yet.
"""

from __future__ import annotations

import torch

from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.factors.linearize import linearize
from graphslam_tpu_torch.solver.normal_eq import assemble_dense, build_blocks


def marginal_covariances_dense(poses: torch.Tensor, graph: FactorGraph) -> torch.Tensor:
    """(N, T, T) marginal covariance of every pose, dense path."""
    lin = linearize(poses, graph)
    sys = build_blocks(lin, graph, poses.shape[0])
    N, T = sys.g.shape
    Hf = assemble_dense(sys, torch.zeros((), dtype=poses.dtype, device=poses.device))
    cov = torch.linalg.inv_ex(Hf.double())[0].to(Hf.dtype).reshape(N, T, N, T)
    idx = torch.arange(N, device=poses.device)
    return cov[idx, :, idx, :]
