"""SE(2): planar rigid transforms stored as (..., 3) tensors [x, y, theta].

Port of graphslam_tpu/geometry/se2.py. compose keeps the base translation
(SURVEY.md §3.6); tangent vectors are body-frame [vx, vy, omega] and the
optimizer's retraction is the right action x <- x * Exp(xi). Every function
broadcasts over leading batch dims.
"""

from __future__ import annotations

import torch

from graphslam_tpu_torch.geometry import so2


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.zeros((*batch_shape, 3), dtype=dtype, device=device)


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a * b: apply b in a's frame."""
    t = a[..., :2] + so2.rotate(a[..., 2], b[..., :2])
    theta = so2.wrap(a[..., 2] + b[..., 2])
    return torch.cat([t, theta[..., None]], dim=-1)


def inverse(a: torch.Tensor) -> torch.Tensor:
    t = -so2.unrotate(a[..., 2], a[..., :2])
    return torch.cat([t, -a[..., 2:3]], dim=-1)


def between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 * b: the relative transform taking frame a to frame b."""
    dt = so2.unrotate(a[..., 2], b[..., :2] - a[..., :2])
    dtheta = so2.wrap(b[..., 2] - a[..., 2])
    return torch.cat([dt, dtheta[..., None]], dim=-1)


def exp(xi: torch.Tensor) -> torch.Tensor:
    """Exponential map se(2) -> SE(2). xi = [vx, vy, omega]."""
    v, w = xi[..., :2], xi[..., 2]
    # V(w) = [[a, -b], [b, a]], a = sin w / w, b = (1 - cos w)/w, in
    # half-angle form to avoid the 1-cos cancellation in float32.
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    half = w_safe / 2.0
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(w_safe) / w_safe)
    b = torch.where(small, w / 2.0 - w**3 / 24.0, 2.0 * torch.sin(half) ** 2 / w_safe)
    x = a * v[..., 0] - b * v[..., 1]
    y = b * v[..., 0] + a * v[..., 1]
    return torch.stack([x, y, so2.wrap(w)], dim=-1)


def log(p: torch.Tensor) -> torch.Tensor:
    """Log map SE(2) -> se(2)."""
    t, w = p[..., :2], so2.wrap(p[..., 2])
    small = torch.abs(w) < 1e-6
    w_safe = torch.where(small, torch.ones_like(w), w)
    half = w / 2.0
    # V^{-1} = [[A, B], [-B, A]], A = (w/2) cot(w/2), B = w/2.
    half_safe = w_safe / 2.0
    A = torch.where(
        small, 1.0 - w * w / 12.0, half_safe * torch.cos(half_safe) / torch.sin(half_safe)
    )
    vx = A * t[..., 0] + half * t[..., 1]
    vy = -half * t[..., 0] + A * t[..., 1]
    return torch.stack([vx, vy, w], dim=-1)


def retract(p: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """Right retraction p * Exp(xi) — the optimizer's manifold update."""
    return compose(p, exp(xi))


def local(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Inverse retraction: Log(p^-1 q)."""
    return log(between(p, q))


def adjoint(p: torch.Tensor) -> torch.Tensor:
    """Adjoint matrix (..., 3, 3): Ad_p xi transports tangents p-frame->world."""
    c, s = torch.cos(p[..., 2]), torch.sin(p[..., 2])
    x, y = p[..., 0], p[..., 1]
    zero = torch.zeros_like(c)
    one = torch.ones_like(c)
    row0 = torch.stack([c, -s, y], dim=-1)
    row1 = torch.stack([s, c, -x], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def _V_terms(w: torch.Tensor):
    """a = sin w / w, b = (1-cos w)/w and their w-derivatives (series-safe)."""
    small = torch.abs(w) < 1e-4
    ws = torch.where(small, torch.ones_like(w), w)
    half = ws / 2.0
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(ws) / ws)
    b = torch.where(small, w / 2.0 - w**3 / 24.0, 2.0 * torch.sin(half) ** 2 / ws)
    da = torch.where(
        small, -w / 3.0 + w**3 / 30.0, (ws * torch.cos(ws) - torch.sin(ws)) / (ws * ws)
    )
    db = torch.where(
        small,
        0.5 - w * w / 8.0,
        (ws * torch.sin(ws) - 2.0 * torch.sin(half) ** 2) / (ws * ws),
    )
    return a, b, da, db


def left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse SE(2) left Jacobian, (..., 3, 3) — closed form.

    Jl(xi) = [[V(w), D(xi)], [0, 1]] with D = V'(w) v - J V(w) v, so
    Jl^{-1} = [[V^{-1}, -V^{-1} D], [0, 1]].
    """
    vx, vy = xi[..., 0], xi[..., 1]
    w = xi[..., 2]
    a, b, da, db = _V_terms(w)
    Vv_x = a * vx - b * vy
    Vv_y = b * vx + a * vy
    dVv_x = da * vx - db * vy
    dVv_y = db * vx + da * vy
    # D = V' v - J (V v); J (x, y) = (-y, x)
    D_x = dVv_x + Vv_y
    D_y = dVv_y - Vv_x
    small = torch.abs(w) < 1e-4
    ws = torch.where(small, torch.ones_like(w), w)
    halfs = ws / 2.0
    A = torch.where(small, 1.0 - w * w / 12.0, halfs * torch.cos(halfs) / torch.sin(halfs))
    B = w / 2.0
    E_x = -(A * D_x + B * D_y)
    E_y = -(-B * D_x + A * D_y)
    zero = torch.zeros_like(w)
    one = torch.ones_like(w)
    row0 = torch.stack([A, B, E_x], dim=-1)
    row1 = torch.stack([-B, A, E_y], dim=-1)
    row2 = torch.stack([zero, zero, one], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse SE(2) right Jacobian: Jr^{-1}(xi) = Jl^{-1}(-xi)."""
    return left_jacobian_inv(-xi)


def transform(p: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose p (..., 3) to points pts (..., N, 2) in p's frame."""
    return so2.rotate(p[..., None, 2], pts) + p[..., None, :2]


def matrix(p: torch.Tensor) -> torch.Tensor:
    """Homogeneous (..., 3, 3) matrix form."""
    top = torch.cat([so2.rotmat(p[..., 2]), p[..., :2, None]], dim=-1)
    bottom = torch.tensor([0.0, 0.0, 1.0], dtype=p.dtype, device=p.device)
    return torch.cat([top, bottom.expand(*p.shape[:-1], 1, 3)], dim=-2)
