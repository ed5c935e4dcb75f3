"""SE(2) and SE(3) in plain torch, written from the textbook formulas.

SE(2) poses are (..., 3) = (x, y, theta) with tangent (vx, vy, omega);
SE(3) poses are (..., 12) = (R row-major, t) with tangent (rho, phi). The
residual of a between factor is Log(z^-1 x_i^-1 x_j) and the update is
the right one, x Exp(d). Every function is smooth at the origin (series
below a small angle), so forward-mode differentiation through it is exact.
"""

from __future__ import annotations

import torch


def _wrap(a):
    return torch.atan2(torch.sin(a), torch.cos(a))


def _rot2(th, v):
    c, s = torch.cos(th), torch.sin(th)
    return torch.stack([c * v[..., 0] - s * v[..., 1], s * v[..., 0] + c * v[..., 1]], -1)


class SE2:
    dim, tangent = 3, 3

    @staticmethod
    def compose(a, b):
        t = a[..., :2] + _rot2(a[..., 2], b[..., :2])
        return torch.cat([t, _wrap(a[..., 2] + b[..., 2])[..., None]], -1)

    @staticmethod
    def between(a, b):
        t = _rot2(-a[..., 2], b[..., :2] - a[..., :2])
        return torch.cat([t, _wrap(b[..., 2] - a[..., 2])[..., None]], -1)

    @staticmethod
    def exp(v):
        w = v[..., 2]
        small = w.abs() < 1e-4
        ws = torch.where(small, torch.ones_like(w), w)
        a = torch.where(small, 1 - w * w / 6, torch.sin(ws) / ws)
        b = torch.where(small, w / 2 - w ** 3 / 24, (1 - torch.cos(ws)) / ws)
        t = torch.stack([a * v[..., 0] - b * v[..., 1], b * v[..., 0] + a * v[..., 1]], -1)
        return torch.cat([t, _wrap(w)[..., None]], -1)

    @staticmethod
    def log(p):
        w = _wrap(p[..., 2])
        small = w.abs() < 1e-4
        hs = torch.where(small, torch.ones_like(w), w / 2)
        A = torch.where(small, 1 - w * w / 12, hs * torch.cos(hs) / torch.sin(hs))
        B = w / 2
        t = p[..., :2]
        return torch.stack([A * t[..., 0] + B * t[..., 1], -B * t[..., 0] + A * t[..., 1], w], -1)

    @staticmethod
    def translation(p):
        return p[..., :2]

    @staticmethod
    def rotation_gap(a, b):
        return _wrap(a[..., 2] - b[..., 2]).abs()

    @staticmethod
    def turned(M, p):
        """The orientations of `p` turned by the 2x2 rotation M."""
        phi = torch.atan2(M[1, 0], M[0, 0])
        return torch.cat([p[..., :2], _wrap(p[..., 2] + phi)[..., None]], -1)


def _hat(w):
    z = torch.zeros_like(w[..., 0])
    return torch.stack([
        torch.stack([z, -w[..., 2], w[..., 1]], -1),
        torch.stack([w[..., 2], z, -w[..., 0]], -1),
        torch.stack([-w[..., 1], w[..., 0], z], -1),
    ], -2)


def _coeffs(phi):
    """(A, B, C) = (sin t / t, (1 - cos t) / t^2, (t - sin t) / t^3), t = |phi|."""
    t2 = (phi * phi).sum(-1)
    small = t2 < 1e-8
    t2s = torch.where(small, torch.ones_like(t2), t2)
    t = torch.sqrt(t2s)
    A = torch.where(small, 1 - t2 / 6, torch.sin(t) / t)
    B = torch.where(small, 0.5 - t2 / 24, (1 - torch.cos(t)) / t2s)
    C = torch.where(small, 1.0 / 6 - t2 / 120, (t - torch.sin(t)) / (t2s * t))
    return A, B, C, t2, small


def _so3_exp(phi):
    A, B, _, _, _ = _coeffs(phi)
    W = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + A[..., None, None] * W + B[..., None, None] * (W @ W)


def _so3_log(R):
    v = torch.stack([R[..., 2, 1] - R[..., 1, 2], R[..., 0, 2] - R[..., 2, 0],
                     R[..., 1, 0] - R[..., 0, 1]], -1) / 2          # sin(t) axis
    c = (R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2] - 1) / 2        # cos(t)
    s2 = (v * v).sum(-1)
    small = s2 < 1e-8
    s = torch.sqrt(torch.where(small, torch.ones_like(s2), s2))
    k = torch.where(small, 1 + s2 / 6, torch.atan2(s, c) / s)
    return k[..., None] * v


def _left_jacobian(phi):
    _, B, C, _, _ = _coeffs(phi)
    W = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    return eye + B[..., None, None] * W + C[..., None, None] * (W @ W)


def _left_jacobian_inv(phi):
    A, B, _, t2, small = _coeffs(phi)
    W = _hat(phi)
    eye = torch.eye(3, dtype=phi.dtype, device=phi.device)
    # 1/t^2 - (1 + cos t) / (2 t sin t) = (1 - A / (2 B)) / t^2
    den = torch.where(small, torch.ones_like(t2), t2)
    D = torch.where(small, 1.0 / 12 + t2 / 720, (1 - A / (2 * B)) / den)
    return eye - 0.5 * W + D[..., None, None] * (W @ W)


def _mv(M, v):
    return (M @ v[..., None])[..., 0]


class SE3:
    dim, tangent = 12, 6

    @staticmethod
    def _split(p):
        return p[..., :9].reshape(p.shape[:-1] + (3, 3)), p[..., 9:]

    @staticmethod
    def _make(R, t):
        return torch.cat([R.reshape(R.shape[:-2] + (9,)), t], -1)

    @staticmethod
    def compose(a, b):
        Ra, ta = SE3._split(a)
        Rb, tb = SE3._split(b)
        return SE3._make(Ra @ Rb, _mv(Ra, tb) + ta)

    @staticmethod
    def between(a, b):
        Ra, ta = SE3._split(a)
        Rb, tb = SE3._split(b)
        RaT = Ra.transpose(-1, -2)
        return SE3._make(RaT @ Rb, _mv(RaT, tb - ta))

    @staticmethod
    def exp(xi):
        rho, phi = xi[..., :3], xi[..., 3:]
        return SE3._make(_so3_exp(phi), _mv(_left_jacobian(phi), rho))

    @staticmethod
    def log(p):
        R, t = SE3._split(p)
        phi = _so3_log(R)
        return torch.cat([_mv(_left_jacobian_inv(phi), t), phi], -1)

    @staticmethod
    def translation(p):
        return p[..., 9:]

    @staticmethod
    def rotation_gap(a, b):
        """The angle of Ra^T Rb."""
        Ra, _ = SE3._split(a)
        Rb, _ = SE3._split(b)
        return _so3_log(Ra.transpose(-1, -2) @ Rb).norm(dim=-1)

    @staticmethod
    def turned(M, p):
        """The orientations of `p` turned by the 3x3 rotation M."""
        R, t = SE3._split(p)
        return SE3._make(M @ R, t)


def group(dim: int):
    """SE2 for (N, 3) poses, SE3 for (N, 12)."""
    return {3: SE2, 12: SE3}[dim]
