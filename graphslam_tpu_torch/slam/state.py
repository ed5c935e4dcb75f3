"""SLAMState: the whole map and graph as preallocated tensors; port of
graphslam_tpu/slam/state.py.

Fixed-capacity tensors plus counts: growth is bumping a count and flipping a
mask bit. Odometry factors live in CHAIN slots (slot k couples keyframes k
and k+1), so the solver's chain fast path and the fused GN kernel apply to
the online graph as they do to offline datasets; loop closures keep explicit
endpoint indices. The counts are 0-d int32 tensors on the state's device.
"""

from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from graphslam_tpu_torch.config import SLAMConfig

_INT_FIELDS = ("num_kf", "loop_edges", "num_loops")
_BOOL_FIELDS = ("kf_masks", "chain_mask", "loop_mask")


@dataclasses.dataclass(frozen=True)
class SLAMState:
    kf_poses: torch.Tensor   # (K, 3) optimized SE(2) poses
    kf_points: torch.Tensor  # (K, P, 2) projected scan points (sensor frame)
    kf_masks: torch.Tensor   # (K, P) point validity
    kf_covs: torch.Tensor    # (K, 3, 3) marginal covariance of each pose
    num_kf: torch.Tensor     # () int32

    # Odometry (chain) factors: slot k couples keyframes (k, k+1).
    chain_meas: torch.Tensor       # (K, 3)
    chain_sqrt_info: torch.Tensor  # (K, 3, 3)
    chain_mask: torch.Tensor       # (K,)

    # Loop-closure factors.
    loop_edges: torch.Tensor      # (F, 2) int32
    loop_meas: torch.Tensor       # (F, 3)
    loop_sqrt_info: torch.Tensor  # (F, 3, 3)
    loop_mask: torch.Tensor       # (F,)
    num_loops: torch.Tensor       # () int32

    anchor: torch.Tensor          # (3,) prior on keyframe 0

    # Odometry accumulated since the last keyframe, and its
    # adjoint-transported covariance.
    odom_accum: torch.Tensor      # (3,)
    odom_cov_accum: torch.Tensor  # (3, 3)

    @property
    def num_factors(self) -> torch.Tensor:
        """Committed factors: one odometry factor per keyframe after the
        first, plus the loops."""
        return torch.clamp(self.num_kf - 1, min=0) + self.num_loops

    @property
    def device(self) -> torch.device:
        return self.kf_poses.device

    def replace(self, **kw) -> "SLAMState":
        return dataclasses.replace(self, **kw)


def init_state(cfg: SLAMConfig, dtype=torch.float32, device="cuda") -> SLAMState:
    """An empty map with cfg's capacities, on `device`."""
    K, F, P = cfg.max_keyframes, cfg.max_factors, cfg.frontend.max_points

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return SLAMState(
        kf_poses=z(K, 3),
        kf_points=z(K, P, 2),
        kf_masks=z(K, P, dt=torch.bool),
        kf_covs=z(K, 3, 3),
        num_kf=z(dt=torch.int32),
        chain_meas=z(K, 3),
        chain_sqrt_info=z(K, 3, 3),
        chain_mask=z(K, dt=torch.bool),
        loop_edges=z(F, 2, dt=torch.int32),
        loop_meas=z(F, 3),
        loop_sqrt_info=z(F, 3, 3),
        loop_mask=z(F, dt=torch.bool),
        num_loops=z(dt=torch.int32),
        anchor=z(3),
        odom_accum=z(3),
        odom_cov_accum=z(3, 3),
    )


def from_numpy(fields: Dict[str, np.ndarray], device="cuda") -> SLAMState:
    """Build a SLAMState from numpy arrays named as its fields (for example
    a JAX SLAMState's arrays fetched with np.asarray). Counts and loop
    endpoints become int32, masks bool, the rest keep their float dtype."""
    out = {}
    for f in dataclasses.fields(SLAMState):
        a = np.asarray(fields[f.name])
        if f.name in _INT_FIELDS:
            a = a.astype(np.int32)
        elif f.name in _BOOL_FIELDS:
            a = a.astype(bool)
        out[f.name] = torch.tensor(a, device=device)
    return SLAMState(**out)
