"""Segment-world raycasting and scripted trajectories (the Stage
equivalent): port of graphslam_tpu/sim/world.py.

The raycaster runs on torch tensors of the caller's device, so the GPU host
makes its replay scans with it; the waypoint helpers are numpy, copied from
the JAX package. Odometry noise takes the same np.random.default_rng(seed)
draws as the JAX package, so one seed gives both packages the same run.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from graphslam_tpu_torch.config import FrontendConfig
from graphslam_tpu_torch.frontend.projection import beam_angles
from graphslam_tpu_torch.geometry import se2


class World(NamedTuple):
    segments: torch.Tensor  # (S, 2, 2): [start xy, end xy] walls


def default_world(device="cuda") -> World:
    """An indoor-ish floorplan: outer box + interior walls/obstacles."""
    segs = []

    def box(x0, y0, x1, y1):
        segs.extend([
            [[x0, y0], [x1, y0]],
            [[x1, y0], [x1, y1]],
            [[x1, y1], [x0, y1]],
            [[x0, y1], [x0, y0]],
        ])

    box(-10.0, -8.0, 10.0, 8.0)          # outer walls
    box(-4.0, -3.0, -1.5, -0.5)          # room/obstacle
    box(2.0, 1.0, 5.0, 4.0)              # another obstacle
    segs.append([[-10.0, 3.0], [-5.0, 3.0]])   # wall stub
    segs.append([[5.0, -8.0], [5.0, -3.5]])    # wall stub
    segs.append([[0.0, -8.0], [0.0, -5.0]])    # wall stub
    return World(segments=torch.tensor(segs, dtype=torch.float32, device=device))


def raycast(world: World, pose: torch.Tensor, angles: torch.Tensor,
            max_range: float) -> torch.Tensor:
    """Cast |angles| rays from SE(2) poses (..., 3); returns ranges (..., B).

    Dense ray-segment intersection over the (B, S) grid."""
    o = pose[..., None, None, :2]                              # (..., 1, 1, 2)
    th = pose[..., 2:3] + angles                               # (..., B)
    d = torch.stack([torch.cos(th), torch.sin(th)], dim=-1)[..., :, None, :]  # (..., B, 1, 2)
    a = world.segments[:, 0]                                   # (S, 2)
    e = world.segments[:, 1] - a                               # (S, 2)
    ao = a - o                                                 # (..., 1, S, 2)

    # Solve o + t d = a + u e: t = cross(ao, e)/cross(d, e), u = cross(ao, d)/cross(d, e)
    cross_de = d[..., 0] * e[:, 1] - d[..., 1] * e[:, 0]       # (..., B, S)
    cross_aoe = ao[..., 0] * e[:, 1] - ao[..., 1] * e[:, 0]
    cross_aod = ao[..., 0] * d[..., 1] - ao[..., 1] * d[..., 0]
    denom = torch.where(torch.abs(cross_de) < 1e-12, torch.full_like(cross_de, 1e-12), cross_de)
    t = cross_aoe / denom
    u = cross_aod / denom
    hit = (t > 1e-6) & (u >= 0.0) & (u <= 1.0)
    t = torch.where(hit, t, torch.full_like(t, float("inf")))
    r = torch.amin(t, dim=-1)
    return torch.clamp(r, max=max_range + 1.0)  # beyond max_range => masked later


def figure_eight_waypoints() -> np.ndarray:
    """A loop-closing tour of the default world (revisits its start)."""
    return np.array(
        [
            [-7.0, -5.0], [-7.0, 0.0], [-7.0, 5.0], [-2.0, 5.5], [0.0, 3.0],
            [0.5, 0.0], [-0.5, -2.5], [2.0, -5.0], [6.5, -5.5], [8.0, -2.0],
            [8.0, 2.0], [6.5, 5.5], [1.5, 6.5], [-2.0, 6.0], [-7.0, 5.0],
            [-7.0, 0.0], [-7.0, -5.0],
        ],
        np.float32,
    )


def _waypoint_trajectory(waypoints: np.ndarray, step_len: float) -> np.ndarray:
    """Piecewise-linear path resampled at ~step_len with headings along the
    path; returns (T, 3) poses."""
    pts = []
    for k in range(len(waypoints) - 1):
        a, b = waypoints[k], waypoints[k + 1]
        seg = b - a
        n = max(1, int(np.ceil(np.linalg.norm(seg) / step_len)))
        for i in range(n):
            pts.append(a + seg * (i / n))
    pts.append(waypoints[-1])
    pts = np.asarray(pts, np.float32)
    headings = np.arctan2(
        np.diff(pts[:, 1], append=pts[-1, 1] + 1e-9),
        np.diff(pts[:, 0], append=pts[-1, 0] + 1e-9),
    ).astype(np.float32)
    return np.concatenate([pts, headings[:, None]], axis=-1)


def simulate_trajectory(
    cfg: FrontendConfig,
    world: Optional[World] = None,
    waypoints: Optional[np.ndarray] = None,
    step_len: float = 0.25,
    odom_trans_sigma: float = 0.01,
    odom_rot_sigma: float = 0.004,
    seed: int = 0,
    device="cuda",
):
    """Run the scripted robot through the world, raycasting on `device`.

    Returns a dict of numpy arrays, as the JAX package does:
      gt_poses    (T, 3)
      scans       (T, B) simulated ranges
      odom_deltas (T-1, 3) noisy relative odometry
    and "world", the World on `device`.
    """
    world = world or default_world(device)
    wps = waypoints if waypoints is not None else figure_eight_waypoints()
    gt = _waypoint_trajectory(wps, step_len)
    angles = beam_angles(cfg.num_beams, cfg.fov_rad, device=device)
    gt_d = torch.from_numpy(gt).to(device)
    scans = raycast(world, gt_d, angles, cfg.max_range).cpu().numpy()

    rng = np.random.default_rng(seed)
    deltas = se2.between(gt_d[:-1], gt_d[1:]).cpu().numpy()
    noise = rng.normal(size=deltas.shape).astype(np.float32) * np.array(
        [odom_trans_sigma, odom_trans_sigma, odom_rot_sigma], np.float32
    )
    return {"gt_poses": gt, "scans": scans, "odom_deltas": deltas + noise, "world": world}
