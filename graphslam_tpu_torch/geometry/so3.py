"""SO(3): 3D rotations stored as (..., 3, 3) rotation matrices.

Port of graphslam_tpu/geometry/so3.py, with the same series switch points:
theta < 1e-6 in exp, left_jacobian and left_jacobian_inv; in log the
k-series for c = cos(theta) > 0.95 and the near-pi branch for c < -0.99,
which takes the axis from the largest column of R + I (the first maximum
wins). Tangents are (..., 3) rotation vectors. Every function broadcasts
over leading batch dims.
"""

from __future__ import annotations

import math

import torch


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return torch.eye(3, dtype=dtype, device=device).expand(*batch_shape, 3, 3)


def hat(w: torch.Tensor) -> torch.Tensor:
    """(..., 3) -> (..., 3, 3) skew-symmetric matrix."""
    x, y, z = w[..., 0], w[..., 1], w[..., 2]
    zero = torch.zeros_like(x)
    return torch.stack([
        torch.stack([zero, -z, y], -1),
        torch.stack([z, zero, -x], -1),
        torch.stack([-y, x, zero], -1),
    ], -2)


def vee(W: torch.Tensor) -> torch.Tensor:
    """(..., 3, 3) skew matrix -> (..., 3) vector."""
    return torch.stack([W[..., 2, 1], W[..., 0, 2], W[..., 1, 0]], -1)


def _eye_like(W: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=W.dtype, device=W.device).expand(W.shape)


def _theta(w: torch.Tensor):
    theta2 = torch.sum(w * w, -1)
    theta = torch.sqrt(theta2)
    small = theta < 1e-6
    return theta2, small, torch.where(small, torch.ones_like(theta), theta)


def exp(w: torch.Tensor) -> torch.Tensor:
    """Rodrigues formula, series-safe near zero."""
    theta2, small, ts = _theta(w)
    a = torch.where(small, 1.0 - theta2 / 6.0, torch.sin(ts) / ts)
    # (1 - cos t)/t^2 = 2 sin^2(t/2)/t^2: the half-angle form avoids cancellation
    b = torch.where(small, 0.5 - theta2 / 24.0, 2.0 * torch.sin(ts / 2.0) ** 2 / (ts * ts))
    W = hat(w)
    return _eye_like(W) + a[..., None, None] * W + b[..., None, None] * (W @ W)


def log(R: torch.Tensor) -> torch.Tensor:
    """Rotation vector from matrix: w = k(c) vee(R - R^T)/2 with
    k = theta/sin(theta) written in c = cos(theta), a series in u = 1 - c
    near the identity, and the axis from the largest column of R + I near
    pi, where the vee part vanishes."""
    trace = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    c = torch.clamp((trace - 1.0) / 2.0, -1.0, 1.0)
    w_skew = vee(R - R.transpose(-1, -2)) / 2.0  # = sin(theta) * axis

    near_id = c > 0.95
    near_pi = c < -0.99

    u = 1.0 - c
    c_safe = torch.where(near_id | near_pi, torch.zeros_like(c), c)
    k_generic = torch.acos(c_safe) * torch.rsqrt(torch.clamp(1.0 - c_safe * c_safe, min=1e-12))
    k_series = 1.0 + u / 3.0 + (2.0 / 15.0) * u * u + (2.0 / 35.0) * u * u * u
    k = torch.where(near_id, k_series, k_generic)
    w_main = k[..., None] * w_skew

    v = 1.0 + c  # = 1 - cos(pi - theta)
    theta_pi = math.pi - torch.sqrt(torch.clamp(2.0 * v, min=0.0)) * (1.0 + v / 12.0)
    Rp = R + _eye_like(R)
    col_norms2 = torch.sum(Rp * Rp, -2)
    kcol = torch.argmax(col_norms2, -1)  # the first maximum wins
    axis_raw = torch.take_along_dim(Rp, kcol[..., None, None], -1)[..., 0]
    axis = axis_raw * torch.rsqrt(
        torch.clamp(torch.sum(axis_raw * axis_raw, -1, keepdim=True), min=1e-12))
    dot = torch.sum(axis * w_skew, -1, keepdim=True)
    sign = torch.where(dot < 0.0, -torch.ones_like(dot), torch.ones_like(dot))
    w_pi = theta_pi[..., None] * axis * sign

    return torch.where(near_pi[..., None], w_pi, w_main)


def left_jacobian(w: torch.Tensor) -> torch.Tensor:
    """SO(3) left Jacobian J_l(w) (..., 3, 3)."""
    theta2, small, ts = _theta(w)
    A = torch.where(small, 0.5 - theta2 / 24.0, 2.0 * torch.sin(ts / 2.0) ** 2 / (ts * ts))
    B = torch.where(small, 1.0 / 6.0 - theta2 / 120.0, (ts - torch.sin(ts)) / (ts**3))
    W = hat(w)
    return _eye_like(W) + A[..., None, None] * W + B[..., None, None] * (W @ W)


def left_jacobian_inv(w: torch.Tensor) -> torch.Tensor:
    """Inverse of the SO(3) left Jacobian."""
    theta2, small, ts = _theta(w)
    half = ts / 2.0
    cot_term = torch.where(
        small,
        1.0 / 12.0 + theta2 / 720.0,
        (1.0 - half * torch.cos(half) / torch.sin(half)) / (ts * ts),
    )
    W = hat(w)
    return _eye_like(W) - 0.5 * W + cot_term[..., None, None] * (W @ W)


def normalize(R: torch.Tensor) -> torch.Tensor:
    """One Newton step of the polar decomposition, R (3I - R^T R)/2: projects
    a near-rotation back onto SO(3). Valid for small perturbations only; use
    `project` for arbitrary 3x3s."""
    RtR = R.transpose(-1, -2) @ R
    return R @ (1.5 * _eye_like(R) - 0.5 * RtR)


def project(M: torch.Tensor) -> torch.Tensor:
    """Nearest rotation (Frobenius) to an arbitrary 3x3: the SVD projection
    U diag(1, 1, det(U V^T)) V^T. Chordal initialization uses it, where the
    linear estimate can be far from orthonormal."""
    U, _, Vt = torch.linalg.svd(M)
    det = torch.linalg.det(U @ Vt)
    D = torch.cat([torch.ones((*det.shape, 2), dtype=M.dtype, device=M.device), det[..., None]], -1)
    return (U * D[..., None, :]) @ Vt
