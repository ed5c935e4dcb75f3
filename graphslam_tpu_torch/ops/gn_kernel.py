"""Fused SE(2) Gauss-Newton and Levenberg-Marquardt in a hand-written CUDA kernel.

Replaces graphslam_tpu/ops/gn_kernel.py::_gn_kernel (the Pallas kernel
reached through `fused_gn_solve`, mode "gn_fused", and through
`fused_lm_solve`, its LM mode). Each GN iteration:

  linearize chain, prior and loop edges     one thread per edge
  assemble block-tridiagonal D/U and g      one thread per node; loop edges
                                            summed through a CSR of each
                                            node's incident edges, in edge
                                            order (no atomics: bitwise
                                            repeatable)
  truncated PCR factor of the chain part    one launch per level
  fixed-count PCG with the Krylov guard     H@v, PCR apply, deterministic
                                            two-pass block reductions; alpha
                                            and beta stay on the device
  right retraction                          one thread per node

An LM iteration (`fused_lm_solve`) damps D's diagonal by (1 + lam), runs a
cold CG, retracts into a candidate, takes the candidate's cost (squares on
chain and prior rows, Huber on every loop edge when huber_delta > 0) and
accepts or rejects it with the lambda schedule, all on the device: lam and
the stats [chi2, lam, accepted steps, converged] never reach the host.

The CUDA source is csrc/gn_kernel.cu (plain C interface, built with nvcc by
ops/_build.py, called through ctypes): one ctypes call per solve, no
host synchronization inside. At m3500 size every array is a few MB and
sits in the 50 MB L2, and one GN iteration is about 190 row stages of a
few microseconds each: as small launches (the staged sequence) the launch
latency bounds it, so a solve runs as ONE launch of a persistent kernel on
a thread-block cluster, with a cluster barrier between stages
(`GnKernel.solve`, `lm_solve`; `solve_staged` and `lm_solve_staged` keep
the staged sequence as the yardstick, bitwise equal).

The TPU layout (sublane packing, one-hot MXU gathers, hi/lo bf16 splits,
1024-node padding, 128-wide edge tiles, page windows) is not carried over;
`edge_tile` and `hvp_splits` are accepted for config parity and ignored.

`fused_gn_solve_reference` is the plain torch twin of the kernel, stage by
stage, with the kernel's own numerics: floor-based angle wrap, the PCR
ridge eps/3*|tr| + 1e-8 with an adjugate inverse without the 1e-8*I of
solver/normal_eq.py::_block_inv, zero-filled PCR shifts at both ends, and
the guard alpha = beta = 0 once pAp or rz <= 1e-30. fused_gn_solve takes the
twin only for tensors on the CPU; for CUDA tensors it launches the kernel
or raises. Line references "gn_kernel.py:N" below are to the JAX kernel,
graphslam_tpu/ops/gn_kernel.py.
"""

from __future__ import annotations

import ctypes
import dataclasses
import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from graphslam_tpu_torch.geometry import se2
from graphslam_tpu_torch.ops.pcg_kernel import _shift_blocks, pcr_apply_reference, pcr_levels_for

_EPS = 3e-4       # PCR ridge (graphslam_tpu gn_kernel.py:1102, gn6_kernel.py:1138)
_TINY = 1e-30     # Krylov-exhaustion guard threshold
_TWO_PI = 2.0 * math.pi


# ---------------------------------------------------------------------------
# Packing (once per solve)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PackedGraph:
    """The graph in the kernel's layout, on the poses' device.

    N nodes; the chain edges k = 0..c-1 couple (k, k+1); El loop edges.
    Masked edges and priors have their z and sqrt-info zeroed.
    """

    N: int
    c: int
    chain_z: torch.Tensor   # (c, 3)
    chain_R: torch.Tensor   # (c, 3, 3)
    prior_z: torch.Tensor   # (N, 3)   per node, zero where no prior
    prior_R: torch.Tensor   # (N, 3, 3)
    loop_i: torch.Tensor    # (El,) int32
    loop_j: torch.Tensor    # (El,) int32
    loop_z: torch.Tensor    # (El, 3)
    loop_R: torch.Tensor    # (El, 3, 3)
    loop_mask: torch.Tensor  # (El,) bool

    @property
    def El(self) -> int:
        return self.loop_i.shape[0]


def pack_graph(graph, N: int) -> PackedGraph:
    """Graph -> kernel layout (graphslam_tpu gn_kernel.py:1032-1069)."""
    dtype = graph.measurements.dtype
    c = min(graph.chain_prefix, N - 1)
    cm = graph.edge_mask[:c].to(dtype)
    lm = graph.edge_mask[c:].to(dtype)
    pm = graph.prior_mask.to(dtype)
    prior_z = torch.zeros((N, 3), dtype=dtype, device=graph.device)
    prior_R = torch.zeros((N, 3, 3), dtype=dtype, device=graph.device)
    pidx = graph.prior_idx.long()
    prior_z[pidx] = graph.prior_meas * pm[:, None]
    prior_R[pidx] = graph.prior_sqrt_info * pm[:, None, None]
    return PackedGraph(
        N=N,
        c=c,
        chain_z=(graph.measurements[:c] * cm[:, None]).contiguous(),
        chain_R=(graph.sqrt_info[:c] * cm[:, None, None]).contiguous(),
        prior_z=prior_z,
        prior_R=prior_R,
        loop_i=graph.edges[c:, 0].to(torch.int32).contiguous(),
        loop_j=graph.edges[c:, 1].to(torch.int32).contiguous(),
        loop_z=(graph.measurements[c:] * lm[:, None]).contiguous(),
        loop_R=(graph.sqrt_info[c:] * lm[:, None, None]).contiguous(),
        loop_mask=graph.edge_mask[c:],
    )


def loop_csr(pk) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each node's incident live loop edges in ascending edge order, for a
    PackedGraph (or the SE(3) kernel's PackedGraph6).

    Returns (ptr (N+1,) int32, ent (2*El,) int32): node n's entries are
    ent[ptr[n]:ptr[n+1]], each 2*l + side with side 0 when n is edge l's i
    endpoint and 1 when it is its j endpoint. Masked edges (zero blocks)
    are left out, after ptr[N]: the online graph's ~1000 masked loop slots
    all end on one node, whose thread would otherwise walk them one by one
    in every H@v. Built on the device without a host round trip."""
    return edge_csr(pk.loop_i, pk.loop_j, pk.loop_mask, pk.N)


def edge_csr(li: torch.Tensor, lj: torch.Tensor, live: torch.Tensor, N: int):
    """`loop_csr` of edges (li, lj) keeping those where `live` holds."""
    El, dev = li.shape[0], li.device
    live = torch.cat([live, live])
    node = torch.where(live, torch.cat([li, lj]).long(), N)
    code = torch.cat([
        2 * torch.arange(El, device=dev), 2 * torch.arange(El, device=dev) + 1
    ])
    order = torch.argsort(node * (2 * El) + code)
    counts = torch.zeros(N + 1, dtype=torch.long, device=dev)
    counts.index_add_(0, node, torch.ones_like(node))
    ptr = torch.zeros(N + 1, dtype=torch.long, device=dev)
    ptr[1:] = torch.cumsum(counts[:-1], 0)
    return ptr.to(torch.int32), code[order].to(torch.int32).contiguous()


def _phases(iterations: int, cg_iters: int, cg_ramp) -> Tuple[Tuple[int, int], ...]:
    """GN phases (n_iters, cg_iters); cg_ramp replaces (iterations, cg_iters)."""
    phases = tuple(cg_ramp) if cg_ramp else ((iterations, cg_iters),)
    return tuple((int(n), int(cg)) for n, cg in phases)


# ---------------------------------------------------------------------------
# The kernel's SE(2) math, plain torch. Angles wrap with floor, not atan2.
# ---------------------------------------------------------------------------


def _wrap(x: torch.Tensor) -> torch.Tensor:
    return x - _TWO_PI * torch.floor((x + math.pi) / _TWO_PI)


def _between(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """a^-1 b on (..., 3) poses."""
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    dx, dy = b[..., 0] - a[..., 0], b[..., 1] - a[..., 1]
    return torch.stack([c * dx + s * dy, -s * dx + c * dy, _wrap(b[..., 2] - a[..., 2])], -1)


def _log(p: torch.Tensor) -> torch.Tensor:
    w = _wrap(p[..., 2])
    small = torch.abs(w) < 1e-6
    halfs = torch.where(small, torch.ones_like(w), w) / 2.0
    A = torch.where(small, 1.0 - w * w / 12.0, halfs * torch.cos(halfs) / torch.sin(halfs))
    half = w / 2.0
    x, y = p[..., 0], p[..., 1]
    return torch.stack([A * x + half * y, -half * x + A * y, w], -1)


def _exp(v: torch.Tensor) -> torch.Tensor:
    w = v[..., 2]
    small = torch.abs(w) < 1e-6
    ws = torch.where(small, torch.ones_like(w), w)
    half = ws / 2.0
    a = torch.where(small, 1.0 - w * w / 6.0, torch.sin(ws) / ws)
    b = torch.where(small, w / 2.0 - w**3 / 24.0, 2.0 * torch.sin(half) ** 2 / ws)
    vx, vy = v[..., 0], v[..., 1]
    return torch.stack([a * vx - b * vy, b * vx + a * vy, _wrap(w)], -1)


def _compose(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    c, s = torch.cos(a[..., 2]), torch.sin(a[..., 2])
    return torch.stack([
        a[..., 0] + c * b[..., 0] - s * b[..., 1],
        a[..., 1] + s * b[..., 0] + c * b[..., 1],
        _wrap(a[..., 2] + b[..., 2]),
    ], -1)


def _mm(A, B):
    return torch.einsum("...ij,...jk->...ik", A, B)


def _mv(A, v):
    return torch.einsum("...ij,...j->...i", A, v)


def _linearize_rows(xi, xj, z, R, huber_delta: float):
    """Whitened (rw, Jiw, Jjw) of between factors (gn_kernel.py:187-214);
    huber_delta > 0 applies the IRLS sqrt-weight min(1, delta/|rw|)."""
    h = _between(xi, xj)
    r = _log(_between(z, h))
    Jr_inv = se2.right_jacobian_inv(r)
    Ji = -_mm(Jr_inv, se2.adjoint(se2.inverse(h)))
    rw, Jiw, Jjw = _mv(R, r), _mm(R, Ji), _mm(R, Jr_inv)
    if huber_delta > 0.0:
        n = torch.sqrt(torch.clamp(torch.sum(rw * rw, -1), min=1e-24))
        sw = torch.sqrt(torch.clamp(huber_delta / n, max=1.0))
        rw, Jiw, Jjw = rw * sw[..., None], Jiw * sw[..., None, None], Jjw * sw[..., None, None]
    return rw, Jiw, Jjw


def _outer(Jiw, Jjw, rw):
    JiT, JjT = Jiw.transpose(-1, -2), Jjw.transpose(-1, -2)
    return _mm(JiT, Jiw), _mm(JiT, Jjw), _mm(JjT, Jjw), _mv(JiT, rw), _mv(JjT, rw)


# ---------------------------------------------------------------------------
# Plain stages
# ---------------------------------------------------------------------------


class GnSystem(NamedTuple):
    """One linearization: diagonal blocks D (N,3,3), chain blocks U
    (N,3,3) with U[n] coupling n and n+1 (zero for n >= c), right-hand side
    b = -g (N,3) and the loop edges' Aij (El,3,3)."""

    D: torch.Tensor
    U: torch.Tensor
    b: torch.Tensor
    Aij_loop: torch.Tensor


def system_reference(
    poses: torch.Tensor, pk: PackedGraph, huber_delta: float = -1.0, lam=None
) -> GnSystem:
    """Linearize and assemble (gn_kernel.py:697-771). With lam (LM mode) D's
    diagonal is scaled by (1 + lam); GN mode (lam None) has no damping."""
    N, c = pk.N, pk.c
    D = torch.zeros((N, 3, 3), dtype=poses.dtype, device=poses.device)
    g = torch.zeros((N, 3), dtype=poses.dtype, device=poses.device)
    U = torch.zeros_like(D)
    if c > 0:
        rw, Jiw, Jjw = _linearize_rows(poses[:c], poses[1 : c + 1], pk.chain_z, pk.chain_R, -1.0)
        Aii, Aij, Ajj, gi, gj = _outer(Jiw, Jjw, rw)
        D[:c] += Aii
        D[1 : c + 1] += Ajj
        g[:c] += gi
        g[1 : c + 1] += gj
        U[:c] = Aij
    # priors: r = Log(z^-1 x), J = Jr^{-1}(r); zero rows where no prior
    rp = _log(_between(pk.prior_z, poses))
    Jpw = _mm(pk.prior_R, se2.right_jacobian_inv(rp))
    rpw = _mv(pk.prior_R, rp)
    D += _mm(Jpw.transpose(-1, -2), Jpw)
    g += _mv(Jpw.transpose(-1, -2), rpw)
    Aij_loop = torch.zeros((0, 3, 3), dtype=poses.dtype, device=poses.device)
    if pk.El > 0:
        li, lj = pk.loop_i.long(), pk.loop_j.long()
        rw, Jiw, Jjw = _linearize_rows(poses[li], poses[lj], pk.loop_z, pk.loop_R, huber_delta)
        Aii, Aij_loop, Ajj, gi, gj = _outer(Jiw, Jjw, rw)
        D.index_add_(0, li, Aii).index_add_(0, lj, Ajj)
        g.index_add_(0, li, gi).index_add_(0, lj, gj)
    if lam is not None:
        D = _damp(D, lam)
    return GnSystem(D=D, U=U, b=-g, Aij_loop=Aij_loop)


def _damp(D: torch.Tensor, lam) -> torch.Tensor:
    """D with its diagonal entries times (1 + lam), as the kernel scales them."""
    eye = torch.eye(D.shape[-1], dtype=torch.bool, device=D.device)
    return torch.where(eye, D * (1.0 + lam), D)


def _ridge(D: torch.Tensor, eps: float) -> torch.Tensor:
    """The kernel's PCR ridge: + (eps/3 |tr| + 1e-8) I (gn_kernel.py:282-286)."""
    tr = D[..., 0, 0] + D[..., 1, 1] + D[..., 2, 2]
    r = (eps / 3.0) * torch.abs(tr) + 1e-8
    return D + r[..., None, None] * torch.eye(3, dtype=D.dtype, device=D.device)


def _binv(M: torch.Tensor) -> torch.Tensor:
    """The kernel's adjugate 3x3 inverse (gn_kernel.py:289-300): row a of the
    inverse is adj row a over det_a = sum_s M[a,s] adj[a,s]; no 1e-8*I."""
    idx = torch.arange(3, device=M.device)
    r1, r2 = (idx + 1) % 3, (idx + 2) % 3
    # adj[a, s] = M[s+1, a+1] M[s+2, a+2] - M[s+1, a+2] M[s+2, a+1]
    Ms1, Ms2 = M[..., r1, :], M[..., r2, :]             # rows s+1, s+2 (by s)
    adj = (
        Ms1[..., :, r1] * Ms2[..., :, r2] - Ms1[..., :, r2] * Ms2[..., :, r1]
    ).transpose(-1, -2)                                   # [..., a, s]
    det = torch.sum(M * adj, dim=-1)
    det = torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    return adj * (1.0 / det)[..., None]


def pcr_factor_reference(D: torch.Tensor, U: torch.Tensor, K: int, eps: float = _EPS,
                         ridge=_ridge, binv=_binv):
    """K-level PCR factor with the kernel's ridge and inverse
    (gn_kernel.py:340-368). Returns (A (K,N,T,T), G (K,N,T,T), Dinv (N,T,T)).
    `ridge` and `binv` are the T=3 ones; the SE(3) kernel passes its own."""
    L = _shift_blocks(U.transpose(-1, -2), 1)  # L[n] = U[n-1]^T
    A_steps, G_steps = [], []
    for k in range(K):
        h = 1 << k
        D = ridge(D, eps)
        Dinv = binv(D)
        alpha = _mm(L, _shift_blocks(Dinv, h))
        gamma = _mm(U, _shift_blocks(Dinv, -h))
        A_steps.append(alpha)
        G_steps.append(gamma)
        D = D - _mm(alpha, _shift_blocks(U, h)) - _mm(gamma, _shift_blocks(L, -h))
        L = -_mm(alpha, _shift_blocks(L, h))
        U = -_mm(gamma, _shift_blocks(U, -h))
    return torch.stack(A_steps), torch.stack(G_steps), binv(ridge(D, eps))


def hvp_reference(sysm: GnSystem, pk: PackedGraph, v: torch.Tensor) -> torch.Tensor:
    """H @ v: diagonal blocks, chain U/L, loop Aij (gn_kernel.py:788-824)."""
    L = _shift_blocks(sysm.U.transpose(-1, -2), 1)
    out = _mv(sysm.D, v) + _mv(sysm.U, _shift_blocks(v, -1)) + _mv(L, _shift_blocks(v, 1))
    if pk.El > 0:
        li, lj = pk.loop_i.long(), pk.loop_j.long()
        out = out.index_add(0, li, _mv(sysm.Aij_loop, v[lj]))
        out = out.index_add(0, lj, _mv(sysm.Aij_loop.transpose(-1, -2), v[li]))
    return out


def cg_reference(
    sysm: GnSystem, pk: PackedGraph, factor, cg_iters: int,
    x0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Fixed-count PCG with the Krylov-exhaustion guard (gn_kernel.py:826-863)."""
    A, G, Dinv = factor
    b = sysm.b
    tiny = torch.tensor(_TINY, dtype=b.dtype, device=b.device)
    zero = torch.zeros((), dtype=b.dtype, device=b.device)
    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x, r = x0, b - hvp_reference(sysm, pk, x0)
    z = pcr_apply_reference(A, G, Dinv, r)
    p = z
    rz = torch.sum(r * z)
    for _ in range(cg_iters):
        Ap = hvp_reference(sysm, pk, p)
        pAp = torch.sum(p * Ap)
        alpha = torch.where(pAp > tiny, rz / torch.maximum(pAp, tiny), zero)
        x = x + alpha * p
        r = r - alpha * Ap
        z = pcr_apply_reference(A, G, Dinv, r)
        rz_new = torch.sum(r * z)
        beta = torch.where(rz > tiny, rz_new / torch.maximum(rz, tiny), zero)
        p = z + beta * p
        rz = rz_new
    return x


def retract_reference(poses: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    return _compose(poses, _exp(x))


class Stages(NamedTuple):
    """The plain stages of one fused kernel: pack(graph, N), system(poses,
    pk, huber_delta, lam), factor(D, U, K), retract(poses, x) and
    chi2(poses, pk, huber_delta). The GN and LM loops below run on the
    SE(2) ones (here) or the SE(3) ones (ops/gn6_kernel.py)."""

    pack: Callable
    system: Callable
    factor: Callable
    retract: Callable
    chi2: Callable


def gn_loop_reference(st: Stages, poses0, graph, iterations: int, cg_iters: int,
                      huber_delta: float, pcr_levels: Optional[int], warm_start: bool,
                      cg_ramp) -> torch.Tensor:
    """The fused kernels' GN loop on plain stages (gn_kernel.py:892-915)."""
    N = poses0.shape[0]
    pk = st.pack(graph, N)
    K = pcr_levels_for(N, pcr_levels)
    poses, x = poses0, None
    for n_k, cg_k in _phases(iterations, cg_iters, cg_ramp):
        for _ in range(n_k):
            sysm = st.system(poses, pk, huber_delta)
            factor = st.factor(sysm.D, sysm.U, K)
            x = cg_reference(sysm, pk, factor, cg_k, x if warm_start else None)
            poses = st.retract(poses, x)
    return poses


def fused_gn_solve_reference(
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
    """Plain torch twin of the fused GN kernel, same arguments and result."""
    return gn_loop_reference(SE2_STAGES, poses0, graph, iterations, cg_iters, huber_delta,
                             pcr_levels, warm_start, cg_ramp)


def _residual(xi, xj, z, R):
    """Whitened between residual, no Jacobians (gn_kernel.py:582-587)."""
    return _mv(R, _log(_between(z, _between(xi, xj))))


def chi2_reference(poses: torch.Tensor, pk: PackedGraph, huber_delta: float = -1.0):
    """The LM mode's cost (gn_kernel.py:651-690): squares on chain and prior
    rows, Huber rho on every loop edge when huber_delta > 0. A () tensor."""
    c = pk.c
    e = torch.zeros((), dtype=poses.dtype, device=poses.device)
    if c > 0:
        rw = _residual(poses[:c], poses[1 : c + 1], pk.chain_z, pk.chain_R)
        e = e + torch.sum(rw * rw)
    rp = _mv(pk.prior_R, _log(_between(pk.prior_z, poses)))
    e = e + torch.sum(rp * rp)
    if pk.El > 0:
        rw = _residual(poses[pk.loop_i.long()], poses[pk.loop_j.long()], pk.loop_z, pk.loop_R)
        et = torch.sum(rw * rw, -1)
        if huber_delta > 0.0:
            n = torch.sqrt(torch.clamp(et, min=1e-24))
            et = torch.where(n <= huber_delta, et, 2.0 * huber_delta * n - huber_delta**2)
        e = e + torch.sum(et)
    return e


def fused_lm_solve_reference(
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
    """Plain torch twin of the kernel's LM mode (gn_kernel.py:911-946), same
    arguments and result: (poses, chi2, lam, accepted steps, converged), the
    last four () float tensors. No host read."""
    return lm_loop_reference(SE2_STAGES, poses0, graph, iterations, cg_iters, huber_delta, lam0,
                             lam_factor, lam_min, lam_max, pcr_levels, abs_tol, rel_tol)


def lm_loop_reference(st: Stages, poses0, graph, iterations: int, cg_iters: int,
                      huber_delta: float, lam0: float, lam_factor: float, lam_min: float,
                      lam_max: float, pcr_levels: Optional[int], abs_tol: float, rel_tol: float):
    """The fused kernels' LM loop on plain stages (gn_kernel.py:911-946)."""
    N = poses0.shape[0]
    pk = st.pack(graph, N)
    K = pcr_levels_for(N, pcr_levels)
    dtype, dev = poses0.dtype, poses0.device
    poses = poses0
    err = st.chi2(poses, pk, huber_delta)
    lam = torch.tensor(lam0, dtype=dtype, device=dev)
    n_acc = torch.zeros((), dtype=dtype, device=dev)
    conv = torch.zeros((), dtype=torch.bool, device=dev)
    for _ in range(iterations):
        sysm = st.system(poses, pk, huber_delta, lam)
        x = cg_reference(sysm, pk, st.factor(sysm.D, sysm.U, K), cg_iters)
        cand = st.retract(poses, x)
        new_err = st.chi2(cand, pk, huber_delta)
        accepted = new_err < err
        poses = torch.where(accepted, cand, poses)
        dec = err - new_err
        conv = conv | (accepted & ((dec < abs_tol) | (dec < rel_tol * err))) | (lam >= lam_max)
        lam = torch.where(accepted, torch.clamp(lam / lam_factor, min=lam_min),
                          torch.clamp(lam * lam_factor, max=lam_max))
        err = torch.where(accepted, new_err, err)
        n_acc = n_acc + accepted.to(dtype)
    return poses, err, lam, n_acc, conv.to(dtype)


SE2_STAGES = Stages(pack_graph, system_reference, pcr_factor_reference, retract_reference,
                    chi2_reference)


# ---------------------------------------------------------------------------
# The CUDA kernel (csrc/gn_kernel.cu) through ctypes
# ---------------------------------------------------------------------------


class _Problem(ctypes.Structure):
    """Mirror of `struct GnProblem` in csrc/gn_kernel.cu (same field order;
    `_lib` checks the size against the C side's gn_problem_size())."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "poses", "cz", "cR", "pz", "pR", "li", "lj", "lz", "lR",
        "csr_ptr", "csr_ent", "D", "U", "b", "x", "ws", "lA", "stats", "stream",
    )] + [(f, ctypes.c_int) for f in ("N", "c", "El", "K", "cg_max")] + [
        (f, ctypes.c_float) for f in ("eps", "huber_delta")
    ]


_ENTRY_ARGS = (
    ("system", []), ("factor", []), ("retract", []),
    ("precond", [ctypes.c_void_p, ctypes.c_void_p]),
    ("cg", [ctypes.c_int, ctypes.c_int]),
    ("solve", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]),
    ("solve_staged", [ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int]),
    ("chi2", [ctypes.c_void_p, ctypes.c_void_p]),
    ("pcg", [ctypes.c_int]),
    ("lm_solve", [ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 6),
    ("lm_solve_staged", [ctypes.c_int, ctypes.c_int] + [ctypes.c_float] * 6),
)


def load_lib(name: str, prefix: str, problem) -> ctypes.CDLL:
    """Build (if needed) and load csrc/<name>.cu, declare its `<prefix>_*`
    entry points and check its problem struct's size against the ctypes
    mirror `problem` (csrc/gn_kernel.cu and csrc/gn6_kernel.cu have the
    same interface over 3x3 and 6x6 blocks)."""
    from graphslam_tpu_torch.ops import _build

    lib = _build.load(name)
    P = ctypes.POINTER(problem)

    def entry(fn):
        return getattr(lib, f"{prefix}_{fn}")

    entry("ws_floats").argtypes = [ctypes.c_int] * 5
    entry("ws_floats").restype = ctypes.c_longlong
    entry("problem_size").argtypes = []
    entry("problem_size").restype = ctypes.c_int
    for fn, extra in _ENTRY_ARGS:
        entry(fn).argtypes = [P] + extra
        entry(fn).restype = ctypes.c_int
    entry("error_string").argtypes = [ctypes.c_int]
    entry("error_string").restype = ctypes.c_char_p
    if entry("problem_size")() != ctypes.sizeof(problem):
        raise RuntimeError(
            f"the problem struct is {entry('problem_size')()} bytes in csrc/{name}.cu but "
            f"{ctypes.sizeof(problem)} in its ctypes mirror {problem.__qualname__}: "
            "the fields differ"
        )
    return lib


def _lib():
    return load_lib("gn_kernel", "gn", _Problem)


def call(lib, prob, device: torch.device, fn: str, *args) -> None:
    """Run lib.<fn>(&prob, *args) on the device's current stream; raise on a
    CUDA error."""
    prob.stream = torch.cuda.current_stream(device).cuda_stream
    rc = getattr(lib, fn)(ctypes.byref(prob), *args)
    if rc != 0:
        msg = getattr(lib, f"{fn.split('_', 1)[0]}_error_string")(rc).decode()
        raise RuntimeError(f"{fn} failed: CUDA error {rc} ({msg})")


def _check_f32(name: str, t: torch.Tensor, shape, device) -> None:
    if t.device != device or t.dtype != torch.float32 or tuple(t.shape) != tuple(shape):
        raise ValueError(
            f"{name}: expected float32 {tuple(shape)} on {device}, got "
            f"{t.dtype} {tuple(t.shape)} on {t.device}"
        )


class GnKernel:
    """One packed problem on the card with the kernel's buffers.

    `solve` runs whole GN phases and `lm_solve` LM iterations, each as ONE
    launch of a persistent kernel on a thread-block cluster; `solve_staged`
    and `lm_solve_staged` run the same computation as the staged sequence
    of small launches (their yardsticks, bitwise equal); `system`,
    `factor`, `precond`, `cg`, `retract` and `chi2` run one stage each on
    the same buffers, so that a check can hold every stage against its plain
    twin. Results: D, U (N,T,T), b, x (N,T), poses (N,P) and, with lm, the
    stats [chi2, lam, accepted steps, converged] (4,), updated in place.
    With lm, `system` damps D's diagonal by (1 + stats[1]).

    T = 3, P = 3 (SE(2), csrc/gn_kernel.cu); ops/gn6_kernel.py::Gn6Kernel
    sets T = 6, P = 12 (SE(3), csrc/gn6_kernel.cu), whose C interface is
    the same.
    """

    T, P, PREFIX = 3, 3, "gn"
    Problem = _Problem
    load = staticmethod(_lib)
    pack = staticmethod(pack_graph)

    def __init__(self, poses: torch.Tensor, graph, huber_delta: float = -1.0,
                 pcr_levels: Optional[int] = None, cg_max: int = 25, lm: bool = False):
        name, T, P = type(self).__name__, self.T, self.P
        if poses.device.type != "cuda":
            raise ValueError(f"{name} needs CUDA tensors, got {poses.device}")
        if graph.tangent_dim != T or poses.ndim != 2 or poses.shape[1] != P:
            raise ValueError(f"{name} takes (N, {P}) poses of a graph with tangent dim {T}")
        N = poses.shape[0]
        dev = poses.device
        if graph.device != dev:
            raise ValueError(f"graph on {graph.device}, poses on {dev}")
        _check_f32("poses", poses, (N, P), dev)
        # the kernel indexes poses by these without bounds checks
        ids = torch.cat([graph.edges.reshape(-1), graph.prior_idx])
        if not bool(((ids >= 0) & (ids < N)).all()):
            raise ValueError(f"edge or prior node ids outside [0, {N})")
        self.lib = self.load()
        self.pk = pk = self.pack(graph, N)
        self.csr_ptr, self.csr_ent = loop_csr(pk)
        self.K = pcr_levels_for(N, pcr_levels)
        self.cg_max = int(cg_max)
        self.poses = poses.clone().contiguous()
        self.D = torch.empty((N, T, T), dtype=torch.float32, device=dev)
        self.U = torch.empty_like(self.D)
        self.b = torch.empty((N, T), dtype=torch.float32, device=dev)
        self.x = torch.zeros_like(self.b)
        self.stats = torch.zeros(4, dtype=torch.float32, device=dev) if lm else None
        n_ws = self._entry("ws_floats")(N, pk.c, pk.El, self.K, self.cg_max)
        self.ws = torch.empty(int(n_ws), dtype=torch.float32, device=dev)
        for label, t, shape in (
            ("chain z", pk.chain_z, (pk.c, P)), ("chain R", pk.chain_R, (pk.c, T, T)),
            ("prior z", pk.prior_z, (N, P)), ("prior R", pk.prior_R, (N, T, T)),
            ("loop z", pk.loop_z, (pk.El, P)), ("loop R", pk.loop_R, (pk.El, T, T)),
        ):
            _check_f32(label, t, shape, dev)
        self.prob = self.Problem(
            *(t.data_ptr() for t in (
                self.poses, pk.chain_z, pk.chain_R, pk.prior_z, pk.prior_R,
                pk.loop_i, pk.loop_j, pk.loop_z, pk.loop_R,
                self.csr_ptr, self.csr_ent, self.D, self.U, self.b, self.x, self.ws,
            )),
            None, self.stats.data_ptr() if lm else None, None,
            N, pk.c, pk.El, self.K, self.cg_max, _EPS, float(huber_delta),
        )

    def _entry(self, fn: str):
        return getattr(self.lib, f"{self.PREFIX}_{fn}")

    def _call(self, fn: str, *args) -> None:
        call(self.lib, self.prob, self.poses.device, f"{self.PREFIX}_{fn}", *args)

    def system(self) -> None:
        self._call("system")

    def factor(self) -> None:
        self._call("factor")

    def precond(self, v: torch.Tensor) -> torch.Tensor:
        _check_f32("v", v, self.b.shape, self.b.device)
        v = v.contiguous()
        out = torch.empty_like(v)
        self._call("precond", v.data_ptr(), out.data_ptr())
        return out

    def cg(self, cg_iters: int, warm_start: bool = False) -> None:
        if not 0 <= cg_iters <= self.cg_max:
            raise ValueError(f"cg_iters {cg_iters} outside [0, {self.cg_max}]")
        self._call("cg", int(cg_iters), int(warm_start))

    def retract(self) -> None:
        self._call("retract")

    def solve(self, phases: Sequence[Tuple[int, int]], warm_start: bool) -> torch.Tensor:
        """GN phases ((iterations, cg), ...) from the current poses, in one
        launch; returns the poses."""
        return self._solve("solve", phases, warm_start)

    def solve_staged(self, phases: Sequence[Tuple[int, int]], warm_start: bool) -> torch.Tensor:
        """`solve` as the staged sequence of launches."""
        return self._solve("solve_staged", phases, warm_start)

    def _solve(self, fn: str, phases, warm_start: bool) -> torch.Tensor:
        if any(cg > self.cg_max or cg < 0 or n < 0 for n, cg in phases):
            raise ValueError(f"phases {phases} outside cg_max {self.cg_max}")
        n_arr = (ctypes.c_int * len(phases))(*(n for n, _ in phases))
        cg_arr = (ctypes.c_int * len(phases))(*(cg for _, cg in phases))
        self._call(fn, len(phases), ctypes.addressof(n_arr), ctypes.addressof(cg_arr),
                   int(warm_start))
        return self.poses

    def chi2(self, poses: torch.Tensor) -> torch.Tensor:
        """The LM cost of `poses` (N, P) on the card, a (1,) tensor."""
        _check_f32("poses", poses, self.poses.shape, self.poses.device)
        poses = poses.contiguous()
        out = torch.empty(1, dtype=torch.float32, device=poses.device)
        self._call("chi2", poses.data_ptr(), out.data_ptr())
        return out

    def lm_solve(self, iterations: int, cg_iters: int, lam0: float, lam_factor: float,
                 lam_min: float, lam_max: float, abs_tol: float, rel_tol: float) -> torch.Tensor:
        """`iterations` LM steps from the current poses, in one launch;
        returns the stats."""
        return self._lm("lm_solve", iterations, cg_iters,
                        lam0, lam_factor, lam_min, lam_max, abs_tol, rel_tol)

    def lm_solve_staged(self, iterations: int, cg_iters: int, *lm_args: float) -> torch.Tensor:
        """`lm_solve` as the staged sequence of launches."""
        return self._lm("lm_solve_staged", iterations, cg_iters, *lm_args)

    def _lm(self, fn: str, iterations: int, cg_iters: int, *lm_args: float) -> torch.Tensor:
        if self.stats is None:
            raise ValueError(f"{fn} needs a {type(self).__name__} built with lm=True")
        if not 0 <= cg_iters <= self.cg_max or iterations < 0:
            raise ValueError(f"cg_iters {cg_iters} outside [0, {self.cg_max}] "
                             f"or iterations {iterations} < 0")
        self._call(fn, int(iterations), int(cg_iters), *(float(v) for v in lm_args))
        return self.stats


def fused_gn_solve(
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
    """Run `iterations` full Gauss-Newton iterations of an SE(2) graph.

    CUDA tensors go through the hand-written kernel (csrc/gn_kernel.cu);
    CPU tensors through `fused_gn_solve_reference`. huber_delta > 0 weights
    every loop edge (matching linearize(use_huber=True) on graphs whose
    non-chain edges are all loops). warm_start seeds each CG from the
    previous GN step's dx; cg_ramp ((n, cg), ...) replaces (iterations,
    cg_iters) with phases. edge_tile and hvp_splits are TPU layout knobs,
    accepted and ignored.
    """
    if poses0.device.type == "cpu":
        return fused_gn_solve_reference(
            poses0, graph, iterations, cg_iters, huber_delta, pcr_levels,
            warm_start=warm_start, cg_ramp=cg_ramp,
        )
    phases = _phases(iterations, cg_iters, cg_ramp)
    kern = GnKernel(poses0, graph, huber_delta, pcr_levels,
                    cg_max=max([cg for _, cg in phases] + [0]))
    out = kern.solve(phases, warm_start)
    fused_gn_solve.launches += 1
    return out


fused_gn_solve.launches = 0


def fused_lm_solve(
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
    """Full Levenberg-Marquardt of an SE(2) graph: `iterations` damped steps,
    each accepted or rejected on its Huber-robustified cost, with the lambda
    schedule (graphslam_tpu gn_kernel.py:1157).

    Returns (poses (N, 3), chi2, lam, accepted steps, converged), the last
    four () float32 tensors on the poses' device; nothing is read back to
    the host. converged latches _lm_loop's test (a small accepted decrease
    per abs_tol / rel_tol, or lam at lam_max); there is no early exit.
    CUDA tensors go through the hand-written kernel, one ctypes call with
    no host synchronization inside; CPU tensors through
    `fused_lm_solve_reference`. edge_tile and hvp_splits are TPU layout
    knobs, accepted and ignored.
    """
    kw = dict(iterations=iterations, cg_iters=cg_iters, huber_delta=huber_delta, lam0=lam0,
              lam_factor=lam_factor, lam_min=lam_min, lam_max=lam_max,
              abs_tol=abs_tol, rel_tol=rel_tol)
    if poses0.device.type == "cpu":
        return fused_lm_solve_reference(poses0, graph, pcr_levels=pcr_levels, **kw)
    kern = GnKernel(poses0, graph, huber_delta, pcr_levels, cg_max=max(cg_iters, 0), lm=True)
    stats = kern.lm_solve(iterations, cg_iters, lam0, lam_factor, lam_min, lam_max,
                          abs_tol, rel_tol)
    fused_lm_solve.launches += 1
    return kern.poses, stats[0], stats[1], stats[2], stats[3]


fused_lm_solve.launches = 0
