"""SE(3): rigid transforms stored as flat (..., 12) tensors.

Port of graphslam_tpu/geometry/se3.py. Layout: [:9] the row-major 3x3
rotation, [9:12] the translation. Tangents are (..., 6) tensors
[rho (3 translation), phi (3 rotation)] with the right retraction
x * Exp(xi), GTSAM's Pose3 convention. Every function broadcasts over
leading batch dims.
"""

from __future__ import annotations

import torch

from graphslam_tpu_torch.geometry import so3

DIM = 12  # storage dim
TANGENT_DIM = 6


def rot(p: torch.Tensor) -> torch.Tensor:
    return p[..., :9].reshape(*p.shape[:-1], 3, 3)


def trans(p: torch.Tensor) -> torch.Tensor:
    return p[..., 9:12]


def make(R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    return torch.cat([R.reshape(*R.shape[:-2], 9), t], -1)


def identity(batch_shape=(), dtype=torch.float32, device=None) -> torch.Tensor:
    return make(so3.identity(batch_shape, dtype, device),
                torch.zeros((*batch_shape, 3), dtype=dtype, device=device))


def _mv(R: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    return (R @ v[..., None])[..., 0]


def compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    Ra, ta = rot(a), trans(a)
    return make(Ra @ rot(b), _mv(Ra, trans(b)) + ta)


def inverse(a: torch.Tensor) -> torch.Tensor:
    RaT = rot(a).transpose(-1, -2)
    return make(RaT, -_mv(RaT, trans(a)))


def between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 * b."""
    RaT = rot(a).transpose(-1, -2)
    return make(RaT @ rot(b), _mv(RaT, trans(b) - trans(a)))


def exp(xi: torch.Tensor) -> torch.Tensor:
    """se(3) -> SE(3). xi = [rho, phi]; t = J_l(phi) rho."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    return make(so3.exp(phi), _mv(so3.left_jacobian(phi), rho))


def log(p: torch.Tensor) -> torch.Tensor:
    phi = so3.log(rot(p))
    rho = _mv(so3.left_jacobian_inv(phi), trans(p))
    return torch.cat([rho, phi], -1)


def retract(p: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    return compose(p, exp(xi))


def local(p: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    return log(between(p, q))


def adjoint(p: torch.Tensor) -> torch.Tensor:
    """(..., 6, 6) adjoint: Ad_p = [[R, hat(t) R], [0, R]]."""
    R = rot(p)
    top = torch.cat([R, so3.hat(trans(p)) @ R], -1)
    bottom = torch.cat([torch.zeros_like(R), R], -1)
    return torch.cat([top, bottom], -2)


def transform(p: torch.Tensor, pts: torch.Tensor) -> torch.Tensor:
    """Apply pose p (..., 12) to points (..., N, 3)."""
    return pts @ rot(p).transpose(-1, -2) + trans(p)[..., None, :]


def renormalize(p: torch.Tensor) -> torch.Tensor:
    """Re-orthonormalize the rotation part (drift control for long runs)."""
    return make(so3.normalize(rot(p)), trans(p))


def _Q_matrix(rho: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """Barfoot's Q(rho, phi), the translation-rotation block of the SE(3)
    left Jacobian (State Estimation for Robotics, eq. 7.86). Every
    theta-ratio switches to its Taylor form below 0.7 rad, where the closed
    forms lose float32 digits to cancellation."""
    theta2 = torch.sum(phi * phi, -1)
    theta = torch.sqrt(theta2)
    small = theta < 0.7
    ts = torch.where(small, torch.ones_like(theta), theta)

    # c1 = (theta - sin)/theta^3
    c1 = torch.where(small, 1.0 / 6.0 - theta2 / 120.0 + theta2 * theta2 / 5040.0,
                     (ts - torch.sin(ts)) / ts**3)
    # c2 = (1 - theta^2/2 - cos)/theta^4 (negative)
    c2 = torch.where(small, -1.0 / 24.0 + theta2 / 720.0 - theta2 * theta2 / 40320.0,
                     (1.0 - ts * ts / 2.0 - torch.cos(ts)) / ts**4)
    # c3i = (theta - sin - theta^3/6)/theta^5 (negative)
    c3i = torch.where(small, -1.0 / 120.0 + theta2 / 5040.0 - theta2 * theta2 / 362880.0,
                      (ts - torch.sin(ts) - ts**3 / 6.0) / ts**5)

    rx = so3.hat(rho)
    px = so3.hat(phi)
    pxrx = px @ rx
    rxpx = rx @ px
    pxrxpx = pxrx @ px

    t1 = 0.5 * rx
    t2 = c1[..., None, None] * (pxrx + rxpx + pxrxpx)
    t3 = -c2[..., None, None] * (px @ pxrx + rxpx @ px - 3.0 * pxrxpx)
    t4 = -0.5 * (c2 - 3.0 * c3i)[..., None, None] * (pxrxpx @ px + px @ pxrxpx)
    return t1 + t2 + t3 + t4


def left_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse SE(3) left Jacobian (..., 6, 6) in [rho, phi] block order:
    with Jl = [[J, Q], [0, J]], Jl^{-1} = [[J^{-1}, -J^{-1} Q J^{-1}], [0, J^{-1}]]."""
    rho, phi = xi[..., :3], xi[..., 3:6]
    Jinv = so3.left_jacobian_inv(phi)
    TR = -Jinv @ _Q_matrix(rho, phi) @ Jinv
    top = torch.cat([Jinv, TR], -1)
    bottom = torch.cat([torch.zeros_like(Jinv), Jinv], -1)
    return torch.cat([top, bottom], -2)


def right_jacobian_inv(xi: torch.Tensor) -> torch.Tensor:
    """Inverse SE(3) right Jacobian: Jr^{-1}(xi) = Jl^{-1}(-xi)."""
    return left_jacobian_inv(-xi)
