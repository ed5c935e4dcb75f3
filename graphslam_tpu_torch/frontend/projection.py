"""Polar laser scan -> Cartesian point buffer: port of
graphslam_tpu/frontend/projection.py.

Invalid beams are masked, not dropped, and the buffer is padded to a fixed
point budget, so every downstream shape is static.
"""

from __future__ import annotations

from typing import Tuple

import torch


def beam_angles(num_beams: int, fov_rad: float, dtype=torch.float32,
                device="cuda") -> torch.Tensor:
    """Beam angles centered on the sensor x-axis (willow.world:8-14 model)."""
    half = fov_rad / 2.0
    return torch.linspace(-half, half, num_beams, dtype=dtype, device=device)


def scan_to_points(
    ranges: torch.Tensor,
    angles: torch.Tensor,
    min_range: float,
    max_range: float,
    max_points: int,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B,) ranges -> ((P, 2) points, (P,) validity mask), P = max_points.

    Beams out of [min_range, max_range], inf or nan are masked."""
    B = ranges.shape[0]
    if max_points < B:
        raise ValueError(f"max_points {max_points} must cover the beam count {B}")
    valid = torch.isfinite(ranges) & (ranges >= min_range) & (ranges <= max_range)
    r = torch.where(valid, ranges, torch.zeros_like(ranges))
    pts = torch.stack([r * torch.cos(angles), r * torch.sin(angles)], dim=-1)
    pad = max_points - B
    pts = torch.nn.functional.pad(pts, (0, 0, 0, pad))
    valid = torch.nn.functional.pad(valid, (0, pad))
    return pts, valid
