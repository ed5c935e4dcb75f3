"""Fused SE(3) Gauss-Newton and Levenberg-Marquardt in a hand-written CUDA kernel (K4).

Replaces graphslam_tpu/ops/gn6_kernel.py::_gn6_kernel, the Pallas kernel
reached through `fused_gn6_solve` (mode "gn_fused" on SE(3) graphs) and
`fused_lm6_solve` (its LM mode). It is K1 (ops/gn_kernel.py) with 6x6
blocks: each GN iteration linearizes the chain, prior and loop edges (one
thread per edge: between, SO(3) log, Jr^-1 with Barfoot's Q, Ad(h^-1),
whitening, Huber on loop edges), assembles D/U and g (one thread per node,
loop edges through a CSR in edge order: no atomics, bitwise repeatable),
factors the chain part by PCR, runs a fixed count of guarded CG iterations
and retracts x <- x Exp(dx) with one polar-Newton renormalization of the
rotation. The LM mode damps D's 6 diagonal entries by (1 + lam), retracts
into a candidate, takes its cost (Huber on every loop edge) and accepts
or rejects it on the device; lam and the stats [chi2, lam, accepted steps,
converged] never reach the host.

The CUDA source is csrc/gn6_kernel.cu (plain C interface, built with nvcc
by ops/_build.py, called through ctypes); it also holds K5
(ops/pcg6_kernel.py). One ctypes call runs a whole solve with no host
synchronization. At sphere2500 size every array sits in the 50 MB L2 and
an iteration at exact PCR (K = 12) is 404 dependent row stages: their
latency bounds it, not bytes or FLOPs. So a solve runs as ONE launch of a
persistent kernel (`Gn6Kernel.solve`, `lm_solve`: one thread-block cluster,
or a cooperative grid where one pass over the rows needs more than 16
CTAs), whose heavy stages give each 6x6 row a group of 6 threads;
`solve_staged` and `lm_solve_staged` run the staged sequence of small
launches, one thread a row, as the yardstick (bitwise equal).

The TPU layout (packed (8, L) fields, 1024-pose padding, one-hot MXU
gathers and scatters, hi/lo bf16 splits, page windows) is not carried
over, and neither is `_acos_no_trig` (gn6_kernel.py:321), which exists
because Mosaic has no arccos: the kernel calls acosf, as geometry/so3.py's
log does. `edge_tile` and `hvp_splits` are accepted and ignored.

`fused_gn6_solve_reference` and `fused_lm6_solve_reference` are the plain
torch twins with the kernel's numerics: masked edges and missing priors
carry an identity measurement and a zero sqrt-information, one prior per
node (a repeated prior index keeps its last prior, as the JAX kernel's
scatter-set does, where the XLA path sums them), the PCR ridge
eps/6 |tr| + 1e-8 on the 6 diagonal entries, the 6x6 inverse as the Schur
complement of the lower-right 3x3 over the 3x3 adjugate inverse, zero-
filled PCR shifts, and the guard alpha = beta = 0 once pAp or rz <= 1e-30.
`fused_gn6_solve` and `fused_lm6_solve` take the twins only for tensors on
the CPU; for CUDA tensors they launch the kernel or raise. Line references
"gn6_kernel.py:N" are to graphslam_tpu/ops/gn6_kernel.py.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Sequence, Tuple

import torch

from graphslam_tpu_torch.geometry import se3
from graphslam_tpu_torch.ops import gn_kernel as gk


# ---------------------------------------------------------------------------
# Packing (once per solve)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedGraph6:
    """The graph in the kernel's layout, on the poses' device.

    N nodes; the chain edges k = 0..c-1 couple (k, k+1); El loop edges.
    Masked edges and missing priors carry the identity pose as measurement
    and a zero sqrt-information (gn6_kernel.py:1086-1103).
    """

    N: int
    c: int
    chain_z: torch.Tensor   # (c, 12)
    chain_R: torch.Tensor   # (c, 6, 6)
    prior_z: torch.Tensor   # (N, 12)   per node, identity where no prior
    prior_R: torch.Tensor   # (N, 6, 6) zero where no prior
    loop_i: torch.Tensor    # (El,) int32
    loop_j: torch.Tensor    # (El,) int32
    loop_z: torch.Tensor    # (El, 12)
    loop_R: torch.Tensor    # (El, 6, 6)
    loop_mask: torch.Tensor  # (El,) bool

    @property
    def El(self) -> int:
        return self.loop_i.shape[0]


def _mask_to_identity(z: torch.Tensor, m: torch.Tensor) -> torch.Tensor:
    return torch.where(m[:, None], z, se3.identity((), z.dtype, z.device))


def pack_graph6(graph, N: int) -> PackedGraph6:
    """Graph -> kernel layout (graphslam_tpu gn6_kernel.py:1078-1110)."""
    if graph.tangent_dim != 6:
        raise ValueError(f"pack_graph6 needs an SE(3) graph, got tangent dim {graph.tangent_dim}")
    dtype, dev = graph.measurements.dtype, graph.device
    c = min(graph.chain_prefix, N - 1)
    cm, lm = graph.edge_mask[:c], graph.edge_mask[c:]
    # one prior per node, the last one listed where an index repeats
    P = graph.prior_idx.shape[0]
    pidx = graph.prior_idx.long()
    last = torch.full((N,), -1, dtype=torch.long, device=dev).scatter_reduce(
        0, pidx, torch.arange(P, device=dev), "amax")
    has = last >= 0
    src = last.clamp(min=0)
    pm = graph.prior_mask
    prior_z = torch.where(has[:, None], _mask_to_identity(graph.prior_meas, pm)[src],
                          se3.identity((), dtype, dev))
    prior_R = torch.where(has[:, None, None],
                          (graph.prior_sqrt_info * pm[:, None, None].to(dtype))[src],
                          torch.zeros((), dtype=dtype, device=dev))
    return PackedGraph6(
        N=N,
        c=c,
        chain_z=_mask_to_identity(graph.measurements[:c], cm).contiguous(),
        chain_R=(graph.sqrt_info[:c] * cm[:, None, None].to(dtype)).contiguous(),
        prior_z=prior_z.contiguous(),
        prior_R=prior_R.contiguous(),
        loop_i=graph.edges[c:, 0].to(torch.int32).contiguous(),
        loop_j=graph.edges[c:, 1].to(torch.int32).contiguous(),
        loop_z=_mask_to_identity(graph.measurements[c:], lm).contiguous(),
        loop_R=(graph.sqrt_info[c:] * lm[:, None, None].to(dtype)).contiguous(),
        loop_mask=lm,
    )


# ---------------------------------------------------------------------------
# Plain stages
# ---------------------------------------------------------------------------


def _mm(A, B):
    return torch.einsum("...ij,...jk->...ik", A, B)


def _mv(A, v):
    return torch.einsum("...ij,...j->...i", A, v)


def _linearize_rows6(xi, xj, z, W, huber_delta: float):
    """Whitened (rw, Jiw, Jjw) of SE(3) between factors (gn6_kernel.py:548-574);
    huber_delta > 0 applies the IRLS sqrt-weight min(1, delta/|rw|)."""
    h = se3.between(xi, xj)
    r = se3.log(se3.between(z, h))
    Jr_inv = se3.right_jacobian_inv(r)
    Ji = -_mm(Jr_inv, se3.adjoint(se3.inverse(h)))
    rw, Jiw, Jjw = _mv(W, r), _mm(W, Ji), _mm(W, Jr_inv)
    if huber_delta > 0.0:
        n = torch.sqrt(torch.clamp(torch.sum(rw * rw, -1), min=1e-24))
        sw = torch.sqrt(torch.clamp(huber_delta / n, max=1.0))
        rw, Jiw, Jjw = rw * sw[..., None], Jiw * sw[..., None, None], Jjw * sw[..., None, None]
    return rw, Jiw, Jjw


def system_reference6(poses: torch.Tensor, pk: PackedGraph6, huber_delta: float = -1.0,
                      lam=None) -> gk.GnSystem:
    """Linearize and assemble (gn6_kernel.py:716-786): D (N,6,6), U (N,6,6)
    with U[n] coupling n and n+1 (zero for n >= c), b = -g (N,6) and the
    loop edges' Aij (El,6,6). With lam (LM mode) D's diagonal is scaled by
    (1 + lam)."""
    N, c = pk.N, pk.c
    D = torch.zeros((N, 6, 6), dtype=poses.dtype, device=poses.device)
    g = torch.zeros((N, 6), dtype=poses.dtype, device=poses.device)
    U = torch.zeros_like(D)
    if c > 0:
        rw, Jiw, Jjw = _linearize_rows6(poses[:c], poses[1 : c + 1], pk.chain_z, pk.chain_R, -1.0)
        Aii, Aij, Ajj, gi, gj = gk._outer(Jiw, Jjw, rw)
        D[:c] += Aii
        D[1 : c + 1] += Ajj
        g[:c] += gi
        g[1 : c + 1] += gj
        U[:c] = Aij
    # priors: r = Log(z^-1 x), J = Jr^{-1}(r); zero rows where no prior
    rp = se3.log(se3.between(pk.prior_z, poses))
    Jpw = _mm(pk.prior_R, se3.right_jacobian_inv(rp))
    D += _mm(Jpw.transpose(-1, -2), Jpw)
    g += _mv(Jpw.transpose(-1, -2), _mv(pk.prior_R, rp))
    Aij_loop = torch.zeros((0, 6, 6), dtype=poses.dtype, device=poses.device)
    if pk.El > 0:
        li, lj = pk.loop_i.long(), pk.loop_j.long()
        rw, Jiw, Jjw = _linearize_rows6(poses[li], poses[lj], pk.loop_z, pk.loop_R, huber_delta)
        Aii, Aij_loop, Ajj, gi, gj = gk._outer(Jiw, Jjw, rw)
        D.index_add_(0, li, Aii).index_add_(0, lj, Ajj)
        g.index_add_(0, li, gi).index_add_(0, lj, gj)
    if lam is not None:
        D = gk._damp(D, lam)
    return gk.GnSystem(D=D, U=U, b=-g, Aij_loop=Aij_loop)


def ridge6(D: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's PCR ridge: + (eps/6 |tr| + 1e-8) I (gn6_kernel.py:127-137)."""
    tr = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1)
    r = (eps / 6.0) * torch.abs(tr) + 1e-8
    return D + r[..., None, None] * torch.eye(6, dtype=D.dtype, device=D.device)


def binv6(M: torch.Tensor) -> torch.Tensor:
    """The kernel's 6x6 inverse (gn6_kernel.py:140-149): the Schur
    complement of S in [[P, Q], [R, S]] over the 3x3 adjugate inverse
    (ops/gn_kernel.py::_binv), the lower-left block taken as TR^T."""
    P, Q, S = M[..., :3, :3], M[..., :3, 3:], M[..., 3:, 3:]
    Sinv = gk._binv(S)
    QSi = _mm(Q, Sinv)
    TL = gk._binv(P - _mm(QSi, Q.transpose(-1, -2)))
    TR = -_mm(TL, QSi)
    BR = Sinv - _mm(QSi.transpose(-1, -2), TR)
    return torch.cat([torch.cat([TL, TR], -1), torch.cat([TR.transpose(-1, -2), BR], -1)], -2)


def pcr_factor_reference6(D: torch.Tensor, U: torch.Tensor, K: int, eps: float = gk._EPS):
    """K-level PCR factor of 6x6 blocks (gn6_kernel.py:171-193). Returns
    (A (K,N,6,6), G (K,N,6,6), Dinv (N,6,6))."""
    return gk.pcr_factor_reference(D, U, K, eps, ridge=ridge6, binv=binv6)


def retract_reference6(poses: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x <- x Exp(dx), then one polar-Newton step on the rotation (:877-882)."""
    return se3.renormalize(se3.compose(poses, se3.exp(x)))


def _residual6(xi, xj, z, W):
    """Whitened between residual, no Jacobians (gn6_kernel.py:577-580)."""
    return _mv(W, se3.log(se3.between(z, se3.between(xi, xj))))


def chi2_reference6(poses: torch.Tensor, pk: PackedGraph6, huber_delta: float = -1.0):
    """The LM mode's cost (gn6_kernel.py:687-714): squares on chain and prior
    rows, Huber rho on every loop edge when huber_delta > 0. A () tensor."""
    c = pk.c
    e = torch.zeros((), dtype=poses.dtype, device=poses.device)
    if c > 0:
        rw = _residual6(poses[:c], poses[1 : c + 1], pk.chain_z, pk.chain_R)
        e = e + torch.sum(rw * rw)
    rp = _mv(pk.prior_R, se3.log(se3.between(pk.prior_z, poses)))
    e = e + torch.sum(rp * rp)
    if pk.El > 0:
        rw = _residual6(poses[pk.loop_i.long()], poses[pk.loop_j.long()], pk.loop_z, pk.loop_R)
        et = torch.sum(rw * rw, -1)
        if huber_delta > 0.0:
            n = torch.sqrt(torch.clamp(et, min=1e-24))
            et = torch.where(n <= huber_delta, et, 2.0 * huber_delta * n - huber_delta**2)
        e = e + torch.sum(et)
    return e


SE3_STAGES = gk.Stages(pack_graph6, system_reference6, pcr_factor_reference6,
                       retract_reference6, chi2_reference6)


def fused_gn6_solve_reference(
    poses0: torch.Tensor,
    graph,
    iterations: int = 10,
    cg_iters: int = 25,
    huber_delta: float = -1.0,
    pcr_levels: Optional[int] = None,
    edge_tile=None,
    hvp_splits=None,
    warm_start: bool = False,
    cg_ramp: Optional[Sequence[Tuple[int, int]]] = None,
) -> torch.Tensor:
    """Plain torch twin of the fused SE(3) GN kernel, same arguments and result."""
    return gk.gn_loop_reference(SE3_STAGES, poses0, graph, iterations, cg_iters, huber_delta,
                                pcr_levels, warm_start, cg_ramp)


def fused_lm6_solve_reference(
    poses0: torch.Tensor,
    graph,
    iterations: int = 30,
    cg_iters: int = 25,
    huber_delta: float = -1.0,
    lam0: float = 1e-5,
    lam_factor: float = 10.0,
    lam_min: float = 1e-10,
    lam_max: float = 1e7,
    pcr_levels: Optional[int] = None,
    edge_tile=None,
    hvp_splits=None,
    abs_tol: float = 1e-9,
    rel_tol: float = 1e-6,
):
    """Plain torch twin of the kernel's LM mode (gn6_kernel.py:917-955), same
    arguments and result: (poses, chi2, lam, accepted steps, converged), the
    last four () float tensors. No host read."""
    return gk.lm_loop_reference(SE3_STAGES, poses0, graph, iterations, cg_iters, huber_delta,
                                lam0, lam_factor, lam_min, lam_max, pcr_levels, abs_tol, rel_tol)


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/gn6_kernel.cu) through ctypes
# ---------------------------------------------------------------------------


class _Problem(ctypes.Structure):
    """Mirror of `struct Gn6Problem` in csrc/gn6_kernel.cu: the fields of
    K1's `GnProblem` over 6x6 blocks (`_lib` checks the size against the C
    side's gn6_problem_size())."""

    _fields_ = gk._Problem._fields_


def _lib():
    return gk.load_lib("gn6_kernel", "gn6", _Problem)


class Gn6Kernel(gk.GnKernel):
    """One packed SE(3) problem on the card with K4's buffers
    (ops/gn_kernel.py::GnKernel at T = 6, P = 12): D, U (N,6,6), b, x (N,6),
    poses (N,12) and, with lm, the stats."""

    T, P, PREFIX = 6, 12, "gn6"
    Problem = _Problem
    load = staticmethod(_lib)
    pack = staticmethod(pack_graph6)


def fused_gn6_solve(
    poses0: torch.Tensor,
    graph,
    iterations: int = 10,
    cg_iters: int = 25,
    huber_delta: float = -1.0,
    pcr_levels: Optional[int] = None,
    edge_tile=None,
    hvp_splits=None,
    warm_start: bool = False,
    cg_ramp: Optional[Sequence[Tuple[int, int]]] = None,
) -> torch.Tensor:
    """Run `iterations` full Gauss-Newton iterations of an SE(3) graph
    (graphslam_tpu gn6_kernel.py:1161).

    CUDA tensors go through the hand-written kernel (csrc/gn6_kernel.cu);
    CPU tensors through `fused_gn6_solve_reference`. huber_delta > 0
    weights every loop edge. warm_start seeds each CG from the previous GN
    step's dx; cg_ramp ((n, cg), ...) replaces (iterations, cg_iters) with
    phases. edge_tile and hvp_splits are TPU layout knobs, accepted and
    ignored.
    """
    if poses0.device.type == "cpu":
        return fused_gn6_solve_reference(
            poses0, graph, iterations, cg_iters, huber_delta, pcr_levels,
            warm_start=warm_start, cg_ramp=cg_ramp,
        )
    phases = gk._phases(iterations, cg_iters, cg_ramp)
    kern = Gn6Kernel(poses0, graph, huber_delta, pcr_levels,
                     cg_max=max([cg for _, cg in phases] + [0]))
    out = kern.solve(phases, warm_start)
    fused_gn6_solve.launches += 1
    return out


fused_gn6_solve.launches = 0


def fused_lm6_solve(
    poses0: torch.Tensor,
    graph,
    iterations: int = 30,
    cg_iters: int = 25,
    huber_delta: float = -1.0,
    lam0: float = 1e-5,
    lam_factor: float = 10.0,
    lam_min: float = 1e-10,
    lam_max: float = 1e7,
    pcr_levels: Optional[int] = None,
    edge_tile=None,
    hvp_splits=None,
    abs_tol: float = 1e-9,
    rel_tol: float = 1e-6,
):
    """Full Levenberg-Marquardt of an SE(3) graph (graphslam_tpu
    gn6_kernel.py:1192): `iterations` damped steps, each accepted or
    rejected on its Huber-robustified cost, with the lambda schedule.

    Returns (poses (N, 12), chi2, lam, accepted steps, converged), the last
    four () float32 tensors on the poses' device; nothing is read back to
    the host. There is no early exit. CUDA tensors go through the
    hand-written kernel, CPU tensors through `fused_lm6_solve_reference`.
    edge_tile and hvp_splits are accepted and ignored.
    """
    kw = dict(iterations=iterations, cg_iters=cg_iters, huber_delta=huber_delta, lam0=lam0,
              lam_factor=lam_factor, lam_min=lam_min, lam_max=lam_max,
              abs_tol=abs_tol, rel_tol=rel_tol)
    if poses0.device.type == "cpu":
        return fused_lm6_solve_reference(poses0, graph, pcr_levels=pcr_levels, **kw)
    kern = Gn6Kernel(poses0, graph, huber_delta, pcr_levels, cg_max=max(cg_iters, 0), lm=True)
    stats = kern.lm_solve(iterations, cg_iters, lam0, lam_factor, lam_min, lam_max,
                          abs_tol, rel_tol)
    fused_lm6_solve.launches += 1
    return kern.poses, stats[0], stats[1], stats[2], stats[3]


fused_lm6_solve.launches = 0
