"""Trajectory evaluation: ATE / RPE for SE(2) and SE(3) (port of graphslam_tpu/metrics.py)."""

from __future__ import annotations

import torch

from graphslam_tpu_torch.geometry import se2, se3


def _positions(poses: torch.Tensor) -> torch.Tensor:
    if poses.shape[-1] == 3:  # SE2 [x,y,theta]
        return poses[..., :2]
    return se3.trans(poses)  # SE3 flat [R|t]


def align_umeyama(est: torch.Tensor, ref: torch.Tensor):
    """Least-squares rigid alignment (rotation + translation, no scale) of
    estimated positions to reference positions: aligned = est @ R.T + t."""
    mu_e = est.mean(dim=0)
    mu_r = ref.mean(dim=0)
    E = est - mu_e
    Rf = ref - mu_r
    C = Rf.T @ E / est.shape[0]
    U, _, Vt = torch.linalg.svd(C)
    d = torch.sign(torch.linalg.det(U @ Vt))
    D = torch.diag(torch.cat([torch.ones(est.shape[-1] - 1, dtype=est.dtype,
                                         device=est.device), d[None]]))
    R = U @ D @ Vt
    t = mu_r - R @ mu_e
    return R, t


def ate(estimate: torch.Tensor, reference: torch.Tensor, align: bool = True) -> torch.Tensor:
    """Absolute trajectory error: RMSE of positions after rigid alignment.
    Accepts SE(2) (N, 3) or SE(3) (N, 12) poses."""
    p_est = _positions(estimate)
    p_ref = _positions(reference)
    if align:
        R, t = align_umeyama(p_est, p_ref)
        p_est = p_est @ R.T + t
    err2 = torch.sum((p_est - p_ref) ** 2, dim=-1)
    return torch.sqrt(torch.mean(err2))


def rpe(estimate: torch.Tensor, reference: torch.Tensor, delta: int = 1) -> torch.Tensor:
    """Relative pose error over index offset `delta` (translation RMSE)."""
    if estimate.shape[-1] == 3:
        rel_e = se2.between(estimate[:-delta], estimate[delta:])
        rel_r = se2.between(reference[:-delta], reference[delta:])
        dt = rel_e[..., :2] - rel_r[..., :2]
    else:
        rel_e = se3.between(estimate[:-delta], estimate[delta:])
        rel_r = se3.between(reference[:-delta], reference[delta:])
        dt = se3.trans(rel_e) - se3.trans(rel_r)
    return torch.sqrt(torch.mean(torch.sum(dt * dt, dim=-1)))
