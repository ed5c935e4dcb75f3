"""Parallel cyclic reduction (PCR) of the block-tridiagonal chain system.

Port of the plain half of graphslam_tpu/ops/pcg_kernel.py: `pcr_factor` and
`pcr_apply_reference`. Unlike the folding cyclic reduction in
solver/tridiag.py, PCR keeps every row in place and eliminates neighbours at
doubling distances h = 2^k; each step is two shifted block products.

The fused whole-CG-loop kernel of that module (K3, `fused_pcg_solve`, mode
"pcg_fused") is not ported yet: it is queued in ROADMAP.md, and will wrap
the CG stage of the fused GN kernel (ops/gn_kernel.py, csrc/gn_kernel.cu).
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch


def _shift_blocks(X: torch.Tensor, s: int) -> torch.Tensor:
    """result[i] = X[i-s] with zero fill at both ends (s may be negative)."""
    if s == 0:
        return X
    Y = torch.zeros_like(X)
    n = X.shape[0]
    if abs(s) >= n:
        return Y
    if s > 0:
        Y[s:] = X[: n - s]
    else:
        Y[: n + s] = X[-s:]
    return Y


def pcr_levels_for(n: int, levels: Optional[int]) -> int:
    """ceil(log2 n) elimination levels, truncated to `levels` when given."""
    K = max(1, math.ceil(math.log2(max(n, 2))))
    if levels is not None:
        K = min(K, max(1, levels))
    return K


def pcr_factor(
    D: torch.Tensor, U: torch.Tensor, eps: float = 3e-4, levels: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCR elimination coefficients for the block-tridiagonal (D, U).

    D (n, T, T): diagonal blocks. U (n, T, T): U[i] couples rows i and i+1
    (zero at i >= n_real-1). `levels` truncates the elimination to distance
    2^levels (None = exact).

    Returns (A, G, Dinv): A[k], G[k] are the step-k coefficients
    (alpha_i = L_i Dinv_{i-h}, gamma_i = U_i Dinv_{i+h}, h = 2^k) and Dinv the
    final diagonal inverse. The rhs recursion
        b_i <- b_i - A[k]_i b_{i-h} - G[k]_i b_{i+h}
    followed by x = Dinv b solves (D, U) x = b (exactly when not truncated).

    Ridge and inverse are the XLA ones (solver/tridiag.py::_regularize and
    solver/normal_eq.py::_block_inv), not the fused GN kernel's.
    """
    from graphslam_tpu_torch.solver.normal_eq import _block_inv
    from graphslam_tpu_torch.solver.tridiag import _regularize

    K = pcr_levels_for(D.shape[0], levels)
    L = _shift_blocks(U.transpose(-1, -2), 1)  # L[i] = U[i-1]^T
    A_steps, G_steps = [], []
    for k in range(K):
        h = 1 << k
        D = _regularize(D, eps)
        Dinv = _block_inv(D)
        alpha = torch.einsum("nij,njk->nik", L, _shift_blocks(Dinv, h))
        gamma = torch.einsum("nij,njk->nik", U, _shift_blocks(Dinv, -h))
        A_steps.append(alpha)
        G_steps.append(gamma)
        D = (
            D
            - torch.einsum("nij,njk->nik", alpha, _shift_blocks(U, h))
            - torch.einsum("nij,njk->nik", gamma, _shift_blocks(L, -h))
        )
        L = -torch.einsum("nij,njk->nik", alpha, _shift_blocks(L, h))
        U = -torch.einsum("nij,njk->nik", gamma, _shift_blocks(U, -h))
    Dinv = _block_inv(_regularize(D, eps))
    return torch.stack(A_steps), torch.stack(G_steps), Dinv


def pcr_apply_reference(A, G, Dinv, b):
    """Plain PCR solve: b (n, T) -> x (n, T)."""
    for k in range(A.shape[0]):
        h = 1 << k
        b = (
            b
            - torch.einsum("nij,nj->ni", A[k], _shift_blocks(b, h))
            - torch.einsum("nij,nj->ni", G[k], _shift_blocks(b, -h))
        )
    return torch.einsum("nij,nj->ni", Dinv, b)
