"""SO(2): planar rotations stored as the angle theta (radians).

Batched: every function broadcasts over leading dims of its inputs.
"""

from __future__ import annotations

import torch


def wrap(theta: torch.Tensor) -> torch.Tensor:
    """Wrap angles to (-pi, pi]. Branch-free."""
    return torch.atan2(torch.sin(theta), torch.cos(theta))


def rotmat(theta: torch.Tensor) -> torch.Tensor:
    """(...,) angle -> (..., 2, 2) rotation matrix."""
    c, s = torch.cos(theta), torch.sin(theta)
    return torch.stack([torch.stack([c, -s], dim=-1), torch.stack([s, c], dim=-1)], dim=-2)


def rotate(theta: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate 2-vectors v (..., 2) by angles theta (...,)."""
    c, s = torch.cos(theta), torch.sin(theta)
    x, y = v[..., 0], v[..., 1]
    return torch.stack([c * x - s * y, s * x + c * y], dim=-1)


def unrotate(theta: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate v by -theta."""
    return rotate(-theta, v)
