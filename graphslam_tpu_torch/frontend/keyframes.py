"""Keyframe gating and the motion-scaled measurement covariance: port of
graphslam_tpu/frontend/keyframes.py.

The reference's motion gate (GICP fitness above 0.1, scanner.cpp:56-70) is
kept, and the quality gate it lacked is added beside it.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphslam_tpu_torch.config import FrontendConfig
from graphslam_tpu_torch.frontend.icp import MatchResult


class KeyframeDecision(NamedTuple):
    is_keyframe: torch.Tensor   # bool: motion gate fired (reference semantics)
    is_reliable: torch.Tensor   # bool: the delta is trustworthy as a factor


def decide_keyframe(match: MatchResult, cfg: FrontendConfig) -> KeyframeDecision:
    moved_enough = (
        (match.fitness > cfg.keyframe_fitness_threshold)
        | (torch.linalg.vector_norm(match.delta[..., :2], dim=-1) > cfg.keyframe_trans_threshold)
        | (torch.abs(match.delta[..., 2]) > cfg.keyframe_rot_threshold)
    )
    reliable = (
        match.converged
        & (match.inlier_rms < cfg.max_match_rmse)
        & (match.matched_frac > 0.5)
    )
    return KeyframeDecision(is_keyframe=moved_enough, is_reliable=reliable)


def motion_covariance(delta: torch.Tensor, cfg: FrontendConfig) -> torch.Tensor:
    """Motion-magnitude-scaled diagonal covariance (scanner.hpp:64-80 and
    odometry.cpp:23, intended semantics):
        sigma^2_xy    = k_disp_disp * dl
        sigma^2_theta = k_rot_disp * dl + k_rot_rot * |dtheta|
    """
    dl = torch.linalg.vector_norm(delta[..., :2], dim=-1)
    dth = torch.abs(delta[..., 2])
    floor = 1e-6
    var_xy = torch.clamp(cfg.k_disp_disp * dl, min=floor)
    var_th = torch.clamp(cfg.k_rot_disp * dl + cfg.k_rot_rot * dth, min=floor)
    zeros = torch.zeros_like(var_xy)
    row0 = torch.stack([var_xy, zeros, zeros], dim=-1)
    row1 = torch.stack([zeros, var_xy, zeros], dim=-1)
    row2 = torch.stack([zeros, zeros, var_th], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)
