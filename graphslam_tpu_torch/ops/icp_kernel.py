"""Fused GICP IRLS iteration (K2): hand-written CUDA kernel and plain twin.

Replaces graphslam_tpu/ops/icp_kernel.py::_kernel, the Pallas kernel behind
`fused_icp_iteration`. One IRLS iteration, for every source point: the
nearest valid target on exact coordinate differences, the matched target's
surfel covariance, the inverse of the 2x2 combined covariance, and the
reduction to the 3-dof normal equations H, g and the match statistics
[sum_d2_all, sum_d2_gated, n_match, sum_mahal].

The CUDA source is csrc/icp_kernel.cu (plain C interface, built with nvcc
by ops/_build.py, called through ctypes); its header says what bounds it
on an H100 and how. Two entry points, each ONE launch of a persistent
kernel on a thread-block cluster (a group of threads a source point scans
the targets, resident in shared memory):

  fused_icp_iteration  one iteration on given moved points (K2 as the JAX
                       package exposes it)
  fused_icp_loop       the whole IRLS loop of frontend/icp.py::gicp_match
                       on the device, no host synchronization; with early
                       exit the loop ends on the device after the round
                       whose |upd| < tol

`fused_icp_iteration_staged` and `fused_icp_loop_staged` run the same
computation as the staged launches (two a round: one thread a point
scanning every target, then one thread's update), their yardstick: delta,
H, stats and |upd| are bitwise equal.

`fused_icp_iteration` takes its plain twin (`fused_icp_iteration_reference`)
only for tensors on the CPU; for CUDA tensors it launches the kernel or
raises. The loops and the staged entries take CUDA tensors only: on the
CPU, gicp_match runs its plain IRLS loop instead. Each counts its
successful launch calls in `.launches`. The TPU layout (the one-hot MXU
gather of a packed (Q, 6) table, (8, 128) output blocks) is not carried
over.
"""

from __future__ import annotations

import ctypes
import functools
from typing import Tuple

import torch

_BIG = 3.4e38  # invalid targets' distance (icp_kernel.py:45)


def fused_icp_iteration_reference(
    moved, jtheta, src_mask, tgt, tgt_valid, Ct, Csr, max_corr2: float, eps: float
):
    """Plain torch twin (icp_kernel.py:167): returns (H (3,3), g (3,),
    stats (4,)) of one IRLS iteration. Ct is (Q, 2, 2); Csr (P, 3) holds the
    rotated source covariances [c11, c12, c22]."""
    dx = moved[:, 0:1] - tgt[None, :, 0]
    dy = moved[:, 1:2] - tgt[None, :, 1]
    d2 = dx * dx + dy * dy
    d2 = torch.where(tgt_valid[None, :], d2, torch.full_like(d2, _BIG))
    nn = torch.argmin(d2, dim=1)
    min_d2 = torch.gather(d2, 1, nn[:, None])[:, 0]
    q = tgt[nn]
    Ctn = Ct[nn]

    valid_any = (min_d2 < _BIG * 0.5) & src_mask
    wf = (valid_any & (min_d2 <= max_corr2)).to(d2.dtype)
    wall = src_mask.to(d2.dtype)

    c11 = Ctn[:, 0, 0] + Csr[:, 0] + eps
    c12 = Ctn[:, 0, 1] + Csr[:, 1]
    c22 = Ctn[:, 1, 1] + Csr[:, 2] + eps
    det = c11 * c22 - c12 * c12
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    m11, m12, m22 = c22 / det, -c12 / det, c11 / det

    ex = q[:, 0] - moved[:, 0]
    ey = q[:, 1] - moved[:, 1]
    jx, jy = jtheta[:, 0], jtheta[:, 1]
    me1 = m11 * ex + m12 * ey
    me2 = m12 * ex + m22 * ey
    h02 = torch.sum(wf * (m11 * jx + m12 * jy))
    h12 = torch.sum(wf * (m12 * jx + m22 * jy))
    h01 = torch.sum(wf * m12)
    H = torch.stack([
        torch.stack([torch.sum(wf * m11), h01, h02]),
        torch.stack([h01, torch.sum(wf * m22), h12]),
        torch.stack([h02, h12,
                     torch.sum(wf * (jx * jx * m11 + 2 * jx * jy * m12 + jy * jy * m22))]),
    ])
    g = torch.stack([torch.sum(wf * me1), torch.sum(wf * me2),
                     torch.sum(wf * (jx * me1 + jy * me2))])
    d2c = torch.clamp(min_d2, max=1e9)
    stats = torch.stack([torch.sum(wall * d2c), torch.sum(wf * d2c), torch.sum(wf),
                         torch.sum(wf * (ex * me1 + ey * me2))])
    return H, g, stats


def rotated_covs(Cs3: torch.Tensor, theta: torch.Tensor) -> torch.Tensor:
    """R(theta) Cs R(theta)^T as [c11, c12, c22] from Cs3 = [a, b, d] (P, 3)
    (the closed form of frontend/icp.py:195-199)."""
    c, s = torch.cos(theta), torch.sin(theta)
    a, b, d = Cs3[:, 0], Cs3[:, 1], Cs3[:, 2]
    return torch.stack([
        c * c * a - 2 * c * s * b + s * s * d,
        c * s * (a - d) + (c * c - s * s) * b,
        s * s * a + 2 * c * s * b + c * c * d,
    ], dim=-1)


def _round_inputs(src, delta):
    """Moved points and dR/dtheta @ src at the estimate delta (icp.py:184-187)."""
    c, s = torch.cos(delta[2]), torch.sin(delta[2])
    x, y = src[:, 0], src[:, 1]
    moved = torch.stack([c * x - s * y + delta[0], s * x + c * y + delta[1]], dim=-1)
    jtheta = torch.stack([-s * x - c * y, c * x - s * y], dim=-1)
    return moved, jtheta


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/icp_kernel.cu) through ctypes
# ---------------------------------------------------------------------------


class _Problem(ctypes.Structure):
    """Mirror of `struct IcpProblem` in csrc/icp_kernel.cu (same field order)."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "pts", "jtheta", "cov", "src_mask", "tgt", "tgt_valid", "ct",
        "partials", "rows", "delta", "out", "ctrl", "stream",
    )] + [(f, ctypes.c_int) for f in ("P", "Q")] + [
        (f, ctypes.c_float) for f in ("max_corr2", "eps", "tol")
    ]


@functools.lru_cache(maxsize=None)
def _lib():
    from graphslam_tpu_torch.ops import _build

    lib = _build.load("icp_kernel")
    P = ctypes.POINTER(_Problem)
    lib.icp_error_string.argtypes = [ctypes.c_int]
    lib.icp_error_string.restype = ctypes.c_char_p
    lib.icp_partials_floats.argtypes = [ctypes.c_int]
    lib.icp_partials_floats.restype = ctypes.c_int
    lib.icp_rows_floats.argtypes = [ctypes.c_int]
    lib.icp_rows_floats.restype = ctypes.c_longlong
    lib.icp_ctas.argtypes = [ctypes.c_int]
    lib.icp_ctas.restype = ctypes.c_int
    lib.icp_loop_tile.argtypes = []
    lib.icp_loop_tile.restype = ctypes.c_int
    for fn in ("icp_iteration", "icp_iteration_staged"):
        getattr(lib, fn).argtypes = [P]
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("icp_match", "icp_match_staged"):
        getattr(lib, fn).argtypes = [P, ctypes.c_int, ctypes.c_int]
        getattr(lib, fn).restype = ctypes.c_int
    for fn in ("nn_search", "nn_search_serial"):
        getattr(lib, fn).argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p]
        getattr(lib, fn).restype = ctypes.c_int
    return lib


def _check(name: str, t: torch.Tensor, dtype, shape, device) -> torch.Tensor:
    """Raise unless t is `dtype` of `shape` on `device`; return it contiguous."""
    if t.device != device or t.dtype != dtype or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected {dtype} {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )
    return t.contiguous()


def _raise_on(rc: int, fn: str) -> None:
    if rc != 0:
        msg = _lib().icp_error_string(rc).decode()
        raise RuntimeError(f"icp_kernel.{fn} failed: CUDA error {rc} ({msg})")


def _problem(src, jtheta, cov, src_mask, tgt, tgt_valid, ct, max_corr2, eps, tol=0.0):
    """Check the inputs and fill the kernel's problem struct. Returns
    (struct, tensors to keep alive while the kernel may run)."""
    dev = src.device
    if dev.type != "cuda":
        raise ValueError(f"the ICP kernel needs CUDA tensors, got {dev}")
    P, Q = src.shape[0], tgt.shape[0]
    if P < 1 or Q < 1:
        raise ValueError(f"need at least one source and one target point, got P={P}, Q={Q}")
    f32 = torch.float32
    keep = [
        _check("points", src, f32, (P, 2), dev),
        None if jtheta is None else _check("jtheta", jtheta, f32, (P, 2), dev),
        _check("source covariances", cov, f32, (P, 3), dev),
        _check("src_mask", src_mask, torch.bool, (P,), dev),
        _check("tgt", tgt, f32, (Q, 2), dev),
        _check("tgt_valid", tgt_valid, torch.bool, (Q,), dev),
        _check("target covariances", ct, f32, (Q, 3), dev),
        torch.empty(_lib().icp_partials_floats(P), dtype=f32, device=dev),
        torch.empty(_lib().icp_rows_floats(P), dtype=f32, device=dev),
        torch.zeros(16, dtype=f32, device=dev),
        torch.zeros(2, dtype=torch.int32, device=dev),
    ]
    ptr = [0 if t is None else t.data_ptr() for t in keep]
    prob = _Problem(
        *ptr[:9], None, ptr[9], ptr[10], torch.cuda.current_stream(dev).cuda_stream, P, Q,
        float(max_corr2), float(eps), float(tol),
    )
    return prob, keep


def _packed(C: torch.Tensor) -> torch.Tensor:
    """(N, 2, 2) symmetric covariances -> (N, 3) [c11, c12, c22]."""
    return torch.stack([C[:, 0, 0], C[:, 0, 1], C[:, 1, 1]], dim=-1)


def _iteration(fn, moved, jtheta, src_mask, tgt, tgt_valid, Ct, Csr, max_corr2, eps):
    """(H, g, stats) of one IRLS iteration through the C entry `fn`."""
    prob, keep = _problem(moved, jtheta, Csr, src_mask, tgt, tgt_valid, _packed(Ct),
                          max_corr2, eps)
    _raise_on(getattr(_lib(), fn)(ctypes.byref(prob)), fn)
    acc = keep[9]
    H = acc[[0, 1, 3, 1, 2, 4, 3, 4, 5]].reshape(3, 3)
    return H, acc[6:9], acc[9:13]


def fused_icp_iteration(
    moved: torch.Tensor,      # (P, 2) source points at the current estimate
    jtheta: torch.Tensor,     # (P, 2) dR/dtheta @ src
    src_mask: torch.Tensor,   # (P,) bool
    tgt: torch.Tensor,        # (Q, 2)
    tgt_valid: torch.Tensor,  # (Q,) bool
    Ct: torch.Tensor,         # (Q, 2, 2) target surfel covariances
    Csr: torch.Tensor,        # (P, 3) rotated source covariances [c11, c12, c22]
    max_corr2: float,
    eps: float,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(H (3,3), g (3,), stats (4,)) of one IRLS iteration: the kernel (one
    launch) for CUDA tensors, `fused_icp_iteration_reference` for CPU
    tensors."""
    if moved.device.type == "cpu":
        return fused_icp_iteration_reference(
            moved, jtheta, src_mask, tgt, tgt_valid, Ct, Csr, max_corr2, eps)
    out = _iteration("icp_iteration", moved, jtheta, src_mask, tgt, tgt_valid, Ct, Csr,
                     max_corr2, eps)
    fused_icp_iteration.launches += 1
    return out


fused_icp_iteration.launches = 0


def fused_icp_iteration_staged(moved, jtheta, src_mask, tgt, tgt_valid, Ct, Csr,
                               max_corr2: float, eps: float):
    """`fused_icp_iteration` through the staged launches (its yardstick, two
    launches); CUDA tensors only."""
    out = _iteration("icp_iteration_staged", moved, jtheta, src_mask, tgt, tgt_valid, Ct, Csr,
                     max_corr2, eps)
    fused_icp_iteration_staged.launches += 1
    return out


fused_icp_iteration_staged.launches = 0


def _loop(fn, src, src_mask, tgt, tgt_valid, Cs, Ct, delta0, iterations, max_corr2, eps, tol,
          early_exit):
    """The IRLS loop through the C entry `fn`: (delta, H_last, stats_last,
    last |upd|), and the device's [done, rounds run]."""
    if iterations < 1:
        raise ValueError(f"iterations must be >= 1, got {iterations}")
    prob, keep = _problem(src, None, _packed(Cs), src_mask, tgt, tgt_valid, _packed(Ct),
                          max_corr2, eps, tol)
    delta = _check("delta0", delta0, torch.float32, (3,), src.device).clone()
    prob.delta = delta.data_ptr()
    _raise_on(getattr(_lib(), fn)(ctypes.byref(prob), int(iterations), int(early_exit)), fn)
    out = keep[9]
    return (delta, out[:9].reshape(3, 3), out[9:13], out[13]), keep[10]


def fused_icp_loop(
    src: torch.Tensor,        # (P, 2) source points in the sensor frame
    src_mask: torch.Tensor,   # (P,) bool
    tgt: torch.Tensor,        # (Q, 2)
    tgt_valid: torch.Tensor,  # (Q,) bool
    Cs: torch.Tensor,         # (P, 2, 2) source surfel covariances
    Ct: torch.Tensor,         # (Q, 2, 2) target surfel covariances
    delta0: torch.Tensor,     # (3,) initial estimate
    iterations: int,
    max_corr2: float,
    eps: float,
    tol: float,
    early_exit: bool = True,
):
    """The IRLS loop of gicp_match: (delta, H_last, stats_last, last |upd|).

    ONE launch runs up to `iterations` rounds with no host synchronization;
    with early_exit the loop ends on the device after the round whose
    |upd| < tol. CUDA tensors only."""
    out, _ = _loop("icp_match", src, src_mask, tgt, tgt_valid, Cs, Ct, delta0, iterations,
                   max_corr2, eps, tol, early_exit)
    fused_icp_loop.launches += 1
    return out


fused_icp_loop.launches = 0


def fused_icp_loop_staged(src, src_mask, tgt, tgt_valid, Cs, Ct, delta0, iterations: int,
                          max_corr2: float, eps: float, tol: float, early_exit: bool = True):
    """`fused_icp_loop` through the staged launches (its yardstick: two a
    round, `iterations` rounds enqueued); CUDA tensors only."""
    out, _ = _loop("icp_match_staged", src, src_mask, tgt, tgt_valid, Cs, Ct, delta0,
                   iterations, max_corr2, eps, tol, early_exit)
    fused_icp_loop_staged.launches += 1
    return out


fused_icp_loop_staged.launches = 0
