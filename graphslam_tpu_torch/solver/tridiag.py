"""Block-tridiagonal solver via cyclic reduction — the chain preconditioner.

Port of graphslam_tpu/solver/tridiag.py. A SLAM Hessian is an odometry chain
(block-tridiagonal) plus sparse loop closures; solving the tridiagonal part
T per CG iteration captures the chain's long 'bending' modes. Block cyclic
reduction does it in log2(N) rounds of batched 3x3 products over halving
block counts, with a dense solve of the last few blocks.

  T = blocktridiag(D_k, U_k):  T[k,k] = D_k,  T[k,k+1] = U_k = T[k+1,k]^T
"""

from __future__ import annotations

from typing import List, NamedTuple, Tuple

import torch

from graphslam_tpu_torch.solver.normal_eq import _block_inv


class CRLevel(NamedTuple):
    Dinv_odd: torch.Tensor  # (no, T, T) inverses of odd diagonal blocks
    UL: torch.Tensor        # (ne, T, T) U[2i-1] (left link of even i), 0-padded
    UR: torch.Tensor        # (ne, T, T) U[2i]   (right link of even i), 0-padded
    DL: torch.Tensor        # (ne, T, T) Dinv_odd[i-1], I-padded at i=0
    DR: torch.Tensor        # (ne, T, T) Dinv_odd[i], I-padded past the end
    Uo: torch.Tensor        # (ne, T, T) U[2i+1], 0-padded (for U' and backsub)


class CRFactor(NamedTuple):
    levels: Tuple[CRLevel, ...]
    root_inv: torch.Tensor  # (m*T, m*T) explicit inverse of the reduced system
    root_n: int             # m = remaining block count at the root


def _eye(T: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(T, dtype=like.dtype, device=like.device)


def _pad_blocks(x: torch.Tensor, n: int, eye: bool = False) -> torch.Tensor:
    """Pad a (m, T, T) block array to (n, T, T) with zeros or identities."""
    m = x.shape[0]
    if m >= n:
        return x[:n]
    T = x.shape[-1]
    fill = _eye(T, x) if eye else torch.zeros((T, T), dtype=x.dtype, device=x.device)
    return torch.cat([x, fill.expand(n - m, T, T)], dim=0)


def _regularize(D: torch.Tensor, eps: float) -> torch.Tensor:
    """Add eps * (trace/T) * I per block: a relative ridge that keeps every
    reduction level SPD in float32 (CG corrects the inexactness)."""
    Tb = D.shape[-1]
    tr = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1) / Tb
    return D + (eps * torch.abs(tr))[:, None, None] * _eye(Tb, D)


def cr_factor(
    D: torch.Tensor, U: torch.Tensor, eps: float = 3e-4, min_blocks: int = 64
) -> CRFactor:
    """Factor the block-tridiagonal (D (n,T,T), U (n-1,T,T)). Reduction stops
    at `min_blocks` and the remaining banded system is inverted densely."""
    levels: List[CRLevel] = []
    n = D.shape[0]
    Tb = D.shape[-1]
    D = _regularize(D, eps)
    while n > min_blocks:
        ne = (n + 1) // 2
        D_even = D[0::2]
        D_odd = D[1::2]
        Dinv_odd = _block_inv(D_odd)
        U_even = U[0::2]
        U_odd = U[1::2]

        zero = torch.zeros((1, Tb, Tb), dtype=D.dtype, device=D.device)
        UL = _pad_blocks(torch.cat([zero, U_odd]), ne)
        UR = _pad_blocks(U_even, ne)
        DL = _pad_blocks(torch.cat([_eye(Tb, D)[None], Dinv_odd]), ne, eye=True)
        DR = _pad_blocks(Dinv_odd, ne, eye=True)
        Uo = _pad_blocks(U_odd, ne)

        levels.append(CRLevel(Dinv_odd=Dinv_odd, UL=UL, UR=UR, DL=DL, DR=DR, Uo=Uo))

        # Reduced system on the even blocks (re-regularized each level).
        leftC = torch.einsum("nba,nbc,ncd->nad", UL, DL, UL)
        rightC = torch.einsum("nab,nbc,ndc->nad", UR, DR, UR)
        D = _regularize(D_even - leftC - rightC, eps)
        U = -torch.einsum("nab,nbc,ncd->nad", UR, DR, Uo)[: ne - 1]
        n = ne

    # Dense root: assemble the (m*T, m*T) banded system and invert it.
    m = n
    A = torch.zeros((m, m, Tb, Tb), dtype=D.dtype, device=D.device)
    idx = torch.arange(m, device=D.device)
    A[idx, idx] = D
    if m > 1:
        i0 = torch.arange(m - 1, device=D.device)
        A[i0, i0 + 1] = U
        A[i0 + 1, i0] = U.transpose(-1, -2)
    Af = A.permute(0, 2, 1, 3).reshape(m * Tb, m * Tb)
    root_inv = torch.linalg.inv(Af + 1e-8 * _eye(m * Tb, D))
    return CRFactor(levels=tuple(levels), root_inv=root_inv, root_n=m)


def cr_solve(factor: CRFactor, b: torch.Tensor) -> torch.Tensor:
    """Solve T x = b using a precomputed CRFactor. b: (n, T)."""
    odds: List[torch.Tensor] = []
    for lv in factor.levels:
        b_even = b[0::2]
        b_odd = b[1::2]
        odds.append(b_odd)
        ne = b_even.shape[0]
        zero = torch.zeros((1, b.shape[-1]), dtype=b.dtype, device=b.device)
        bL = torch.cat([zero, b_odd])[:ne]          # b_odd[i-1]
        bR = torch.cat([b_odd, zero])[:ne]          # b_odd[i]
        b = (
            b_even
            - torch.einsum("nba,nbc,nc->na", lv.UL, lv.DL, bL)
            - torch.einsum("nab,nbc,nc->na", lv.UR, lv.DR, bR)
        )

    x = (factor.root_inv @ b.reshape(-1)).reshape(factor.root_n, b.shape[-1])

    for lv, b_odd in zip(reversed(factor.levels), reversed(odds)):
        no = b_odd.shape[0]
        ne = x.shape[0]
        zero = torch.zeros((1, x.shape[-1]), dtype=x.dtype, device=x.device)
        x_right = torch.cat([x[1:], zero])[:no]      # x_even[i+1]
        rhs = (
            b_odd
            - torch.einsum("nba,nb->na", lv.UR[:no], x[:no])
            - torch.einsum("nab,nb->na", lv.Uo[:no], x_right)
        )
        x_odd = torch.einsum("nab,nb->na", lv.Dinv_odd, rhs)
        out = torch.zeros((ne + no, x.shape[-1]), dtype=x.dtype, device=x.device)
        out[0::2] = x[:ne]
        out[1::2] = x_odd
        x = out
    return x


def chain_offdiag(edges: torch.Tensor, Aij: torch.Tensor, num_poses: int) -> torch.Tensor:
    """Extract the chain (j == i+1) off-diagonal blocks U (N-1, T, T) from the
    per-edge Hessian blocks. Loop edges are excluded — they stay with CG."""
    Tb = Aij.shape[-1]
    i_idx = edges[:, 0].long()
    is_chain = edges[:, 1].long() == i_idx + 1
    contrib = torch.where(is_chain[:, None, None], Aij, torch.zeros_like(Aij))
    U = torch.zeros((num_poses - 1, Tb, Tb), dtype=Aij.dtype, device=Aij.device)
    return U.index_add_(0, torch.clamp(i_idx, 0, num_poses - 2), contrib)
