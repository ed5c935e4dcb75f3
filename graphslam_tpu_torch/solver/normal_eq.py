"""Normal-equation assembly and solves for the pose-graph optimizer.

Port of graphslam_tpu/solver/normal_eq.py. From a `Linearization` we form the
damped Gauss-Newton system (H + lambda*D) dx = -g with

  H = sum_e [Ji Jj]^T [Ji Jj]  +  sum_p Jp^T Jp        (block-sparse, TxT blocks)
  g = sum_e [Ji Jj]^T r        +  sum_p Jp^T rp

dense_solve scatters the blocks into the full matrix and Cholesky-solves;
pcg_solve never forms H and runs preconditioned CG on the edge blocks. These
are the plain torch paths (modes "dense" and "pcg"); the fused CUDA kernels
live in ops/gn_kernel.py (SE(2)) and ops/gn6_kernel.py (SE(3)).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.factors.linearize import Linearization


class BlockSystem(NamedTuple):
    """Gauss-Newton system in edge-block form.

    Aii, Aij, Ajj (E, T, T): per-edge Hessian contributions
      Aii = Ji^T Ji, Aij = Ji^T Jj, Ajj = Jj^T Jj
    diag (N, T, T): assembled block diagonal of H (including priors)
    g    (N, T):    gradient J^T r
    edges (E, 2)
    """

    Aii: torch.Tensor
    Aij: torch.Tensor
    Ajj: torch.Tensor
    diag: torch.Tensor
    g: torch.Tensor
    edges: torch.Tensor


def build_blocks(lin: Linearization, graph: FactorGraph, num_poses: int) -> BlockSystem:
    """Edge-block Hessian + gradient from a linearization. Chain-prefix edges
    (k, k+1) assemble with slice-adds; only the loop edges scatter."""
    Ji, Jj, r = lin.Ji, lin.Jj, lin.r
    Aii = torch.einsum("eki,ekj->eij", Ji, Ji)
    Aij = torch.einsum("eki,ekj->eij", Ji, Jj)
    Ajj = torch.einsum("eki,ekj->eij", Jj, Jj)
    gi = torch.einsum("eki,ek->ei", Ji, r)
    gj = torch.einsum("eki,ek->ei", Jj, r)

    T = r.shape[-1]
    c = min(graph.chain_prefix, num_poses - 1)

    g = torch.zeros((num_poses, T), dtype=r.dtype, device=r.device)
    diag = torch.zeros((num_poses, T, T), dtype=r.dtype, device=r.device)
    if c > 0:
        g[:c] += gi[:c]
        g[1 : c + 1] += gj[:c]
        diag[:c] += Aii[:c]
        diag[1 : c + 1] += Ajj[:c]
    i_idx = graph.edges[c:, 0].long()
    j_idx = graph.edges[c:, 1].long()
    # index_put_ with accumulate sums repeated indices in a fixed order on
    # CUDA too (index_add_ there uses float atomics), so the online
    # pipeline's covariances repeat bitwise.
    if i_idx.shape[0] > 0:
        g.index_put_((i_idx,), gi[c:], accumulate=True).index_put_((j_idx,), gj[c:], accumulate=True)
        diag.index_put_((i_idx,), Aii[c:], accumulate=True)
        diag.index_put_((j_idx,), Ajj[c:], accumulate=True)

    # Priors contribute only to the diagonal and gradient.
    Ap = torch.einsum("pki,pkj->pij", lin.Jp, lin.Jp)
    gp = torch.einsum("pki,pk->pi", lin.Jp, lin.rp)
    p_idx = graph.prior_idx.long()
    diag.index_put_((p_idx,), Ap, accumulate=True)
    g.index_put_((p_idx,), gp, accumulate=True)

    return BlockSystem(Aii=Aii, Aij=Aij, Ajj=Ajj, diag=diag, g=g, edges=graph.edges)


def _damped_diag(sys: BlockSystem, lam, lm_diag_scaling: bool = True):
    """LM damping: lambda * diag(H) (Marquardt) or lambda * I."""
    T = sys.diag.shape[-1]
    eye = torch.eye(T, dtype=sys.diag.dtype, device=sys.diag.device)
    if lm_diag_scaling:
        d = torch.diagonal(sys.diag, dim1=-2, dim2=-1)
        return sys.diag + lam * d[..., None] * eye
    return sys.diag + lam * eye


# ---------------------------------------------------------------------------
# Dense backend
# ---------------------------------------------------------------------------


def assemble_dense(sys: BlockSystem, lam, lm_diag_scaling: bool = True) -> torch.Tensor:
    """Scatter the edge blocks into the full (N*T, N*T) damped Hessian."""
    N, T = sys.g.shape
    H = torch.zeros((N, N, T, T), dtype=sys.g.dtype, device=sys.g.device)
    i_idx, j_idx = sys.edges[:, 0].long(), sys.edges[:, 1].long()
    H.index_put_((i_idx, i_idx), sys.Aii, accumulate=True)
    H.index_put_((j_idx, j_idx), sys.Ajj, accumulate=True)
    H.index_put_((i_idx, j_idx), sys.Aij, accumulate=True)
    H.index_put_((j_idx, i_idx), sys.Aij.transpose(-1, -2), accumulate=True)
    # Replace the block diagonal with the (prior-inclusive, damped) one.
    idx = torch.arange(N, device=H.device)
    H[idx, idx] = _damped_diag(sys, lam, lm_diag_scaling)
    Hf = H.permute(0, 2, 1, 3).reshape(N * T, N * T)
    return Hf + 1e-10 * torch.eye(N * T, dtype=Hf.dtype, device=Hf.device)


def dense_solve(sys: BlockSystem, lam, lm_diag_scaling: bool = True) -> torch.Tensor:
    """Assemble the full damped Hessian and Cholesky-solve. Returns dx (N, T)."""
    N, T = sys.g.shape
    L = torch.linalg.cholesky(assemble_dense(sys, lam, lm_diag_scaling))
    rhs = -sys.g.reshape(N * T, 1)
    return torch.cholesky_solve(rhs, L).reshape(N, T)


# ---------------------------------------------------------------------------
# Matrix-free PCG backend
# ---------------------------------------------------------------------------


def hvp(
    sys: BlockSystem,
    damped_diag: torch.Tensor,
    v: torch.Tensor,
    chain_prefix: int = 0,
) -> torch.Tensor:
    """(H + damping) @ v without materializing H. Chain-prefix edges add
    through shifted slices; loop edges gather, multiply and scatter-add."""
    out = torch.einsum("nij,nj->ni", damped_diag, v)
    c = min(chain_prefix, v.shape[0] - 1)
    if c > 0:
        A = sys.Aij[:c]
        out[:c] += torch.einsum("eij,ej->ei", A, v[1 : c + 1])
        out[1 : c + 1] += torch.einsum("eji,ej->ei", A, v[:c])
    i_idx, j_idx = sys.edges[c:, 0].long(), sys.edges[c:, 1].long()
    if i_idx.shape[0] > 0:
        Al = sys.Aij[c:]
        out.index_add_(0, i_idx, torch.einsum("eij,ej->ei", Al, v[j_idx]))
        out.index_add_(0, j_idx, torch.einsum("eji,ej->ei", Al, v[i_idx]))
    return out


def _inv3x3(A: torch.Tensor) -> torch.Tensor:
    """Closed-form cofactor inverse of batched symmetric 3x3 blocks."""
    a, b, c = A[..., 0, 0], A[..., 0, 1], A[..., 0, 2]
    d, e, f = A[..., 1, 1], A[..., 1, 2], A[..., 2, 2]
    co00 = d * f - e * e
    co01 = c * e - b * f
    co02 = b * e - c * d
    co11 = a * f - c * c
    co12 = b * c - a * e
    co22 = a * d - b * b
    det = a * co00 + b * co01 + c * co02
    inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
    row0 = torch.stack([co00, co01, co02], dim=-1)
    row1 = torch.stack([co01, co11, co12], dim=-1)
    row2 = torch.stack([co02, co12, co22], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2) * inv_det[..., None, None]


def _block_inv(blocks: torch.Tensor) -> torch.Tensor:
    """Batched SPD TxT inverse with a 1e-8 ridge: closed forms for T = 2 and
    3; for T = 6 the Schur complement of the lower-right 3x3 on the 3x3
    closed form; otherwise through a Cholesky factor."""
    T = blocks.shape[-1]
    A = blocks + 1e-8 * torch.eye(T, dtype=blocks.dtype, device=blocks.device)
    if T == 2:
        a, b = A[..., 0, 0], A[..., 0, 1]
        c, d = A[..., 1, 0], A[..., 1, 1]
        det = a * d - b * c
        inv_det = 1.0 / torch.where(torch.abs(det) < 1e-20, torch.full_like(det, 1e-20), det)
        row0 = torch.stack([d, -b], dim=-1)
        row1 = torch.stack([-c, a], dim=-1)
        return torch.stack([row0, row1], dim=-2) * inv_det[..., None, None]
    if T == 3:
        return _inv3x3(A)
    if T == 6:
        # [[P, Q], [Q^T, S]]^-1 via the Schur complement of S
        P, Q, S = A[..., :3, :3], A[..., :3, 3:], A[..., 3:, 3:]
        S_inv = _inv3x3(S)
        QSi = Q @ S_inv
        TL = _inv3x3(P - QSi @ Q.transpose(-1, -2))
        TR = -TL @ QSi
        BR = S_inv - QSi.transpose(-1, -2) @ TR
        return torch.cat([torch.cat([TL, TR], -1), torch.cat([TR.transpose(-1, -2), BR], -1)], -2)
    Linv = torch.linalg.solve_triangular(
        torch.linalg.cholesky(A), torch.eye(T, dtype=A.dtype, device=A.device).expand(A.shape),
        upper=False)
    return torch.einsum("nki,nkj->nij", Linv, Linv)


def pcg_solve(
    sys: BlockSystem,
    lam,
    max_iters: int = 250,
    tol: float = 1e-8,
    lm_diag_scaling: bool = True,
    preconditioner: str = "tridiag",
    chain_prefix: int = 0,
    x0: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Preconditioned CG on (H + damping) dx = -g, from x0 (zero if None).

    preconditioner "tridiag" solves the block-tridiagonal odometry-chain part
    of H by cyclic reduction (solver/tridiag.py); "jacobi" inverts the block
    diagonal. The JAX version stops in a while_loop once |r|^2 <= tol^2 |b|^2;
    here each iteration freezes its update once that holds, which gives the
    same iterates without a host round trip per iteration.
    """
    from graphslam_tpu_torch.solver.tridiag import chain_offdiag, cr_factor, cr_solve

    damped = _damped_diag(sys, lam, lm_diag_scaling)
    b = -sys.g

    if preconditioner == "tridiag" and sys.g.shape[0] > 1:
        U = chain_offdiag(sys.edges, sys.Aij, sys.g.shape[0])
        factor = cr_factor(damped, U)

        def precond(r):
            return cr_solve(factor, r)

    else:
        Minv = _block_inv(damped)

        def precond(r):
            return torch.einsum("nij,nj->ni", Minv, r)

    if x0 is None:
        x, r = torch.zeros_like(b), b
    else:
        x = x0
        r = b - hvp(sys, damped, x0, chain_prefix)
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    thresh = tol * tol * torch.sum(b * b)
    tiny = torch.tensor(1e-30, dtype=b.dtype, device=b.device)

    for _ in range(max_iters):
        active = torch.sum(r * r) > thresh
        Ap = hvp(sys, damped, p, chain_prefix)
        alpha = rz / torch.maximum(torch.sum(p * Ap), tiny)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = torch.sum(r_new * z)
        beta = rz_new / torch.maximum(rz, tiny)
        p_new = z + beta * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
    return x
