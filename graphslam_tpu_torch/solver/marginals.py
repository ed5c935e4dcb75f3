"""Marginal covariance recovery (gtsam::Marginals::marginalCovariance):
port of graphslam_tpu/solver/marginals.py.

Three paths, as in the JAX package, all outside any kernel:

  * dense  — invert the assembled Hessian and read the diagonal blocks
    (torch.linalg.inv_ex, which checks no error flag and so never waits for
    the device). The float32 Hessian is inverted in float64: on online
    maps its condition number reaches ~1e8, where a float32 inverse is off
    by a few 1e-3 of the largest entry (the JAX package's by 2.9%,
    scripts/port_precision_report.py).
  * cg     — one pose on a large graph: the T canonical columns solved by
    preconditioned CG as one batch, each column's updates frozen where the
    JAX while_loop stops it, over a fixed count of iterations (no host
    read).
  * all    — ALL-pose marginals at city10000 scale
    (marginal_covariances_all): selected inverse of the block-tridiagonal
    chain + prior part by forward/backward Schur recursions, corrected for
    the loop closures with one Woodbury identity; the only dense object is
    the (T*L, T*L) loop capacitance. Float32, as in the JAX package; its
    Woodbury subtraction cancels on long chains anchored at one end, so
    the online pipeline takes the dense path up to 2048 poses.

The recursions are sequential over the poses (Python loops of small
batched products, the JAX lax.scans); priors and the dense path's blocks
sum through index_put_ with accumulate, in a fixed order on CUDA too.
"""

from __future__ import annotations

import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.factors.linearize import linearize
from graphslam_tpu_torch.solver.normal_eq import (
    BlockSystem,
    _block_inv,
    _damped_diag,
    assemble_dense,
    build_blocks,
)


def marginal_covariances_dense(poses: torch.Tensor, graph: FactorGraph) -> torch.Tensor:
    """(N, T, T) marginal covariance of every pose, dense path."""
    lin = linearize(poses, graph)
    sys = build_blocks(lin, graph, poses.shape[0])
    N, T = sys.g.shape
    Hf = assemble_dense(sys, torch.zeros((), dtype=poses.dtype, device=poses.device))
    cov = torch.linalg.inv_ex(Hf.double())[0].to(Hf.dtype).reshape(N, T, N, T)
    idx = torch.arange(N, device=poses.device)
    return cov[idx, :, idx, :]


def _chain_prior_system(poses, graph: FactorGraph):
    """(D0, U, loop data): the block-tridiagonal chain+prior part of H and
    the whitened loop-edge Jacobian blocks for the Woodbury correction.

    H = T0 + A^T A with T0 the (SPD) anchored chain system and A the
    (T*L, T*N) stacked loop rows: row block e holds Jiw_e at column block
    i_e and Jjw_e at j_e.
    """
    lin = linearize(poses, graph)
    N, T = poses.shape[0], graph.tangent_dim
    c = min(graph.chain_prefix, N - 1)
    Ji, Jj, r = lin.Ji, lin.Jj, lin.r

    Aii = torch.einsum("eki,ekj->eij", Ji[:c], Ji[:c])
    Aij = torch.einsum("eki,ekj->eij", Ji[:c], Jj[:c])
    Ajj = torch.einsum("eki,ekj->eij", Jj[:c], Jj[:c])
    D0 = torch.zeros((N, T, T), dtype=r.dtype, device=r.device)
    D0[:c] += Aii
    D0[1:c + 1] += Ajj
    U = torch.zeros((N, T, T), dtype=r.dtype, device=r.device)
    U[:c] = Aij  # U[k]: rows k, k+1

    Ap = torch.einsum("pki,pkj->pij", lin.Jp, lin.Jp)
    D0.index_put_((graph.prior_idx.long(),), Ap, accumulate=True)

    loop_i = graph.edges[c:, 0].long()
    loop_j = graph.edges[c:, 1].long()
    return D0, U, (loop_i, loop_j, Ji[c:], Jj[c:])


def _inv1(F: torch.Tensor) -> torch.Tensor:
    return _block_inv(F[None])[0]


def _tridiag_selected_inverse(D, U):
    """Diagonal blocks of T0^{-1} for the block-tridiagonal (D, U).

    Classic two-sided Schur recursion: with forward complements
    F_i = D_i - U_{i-1}^T F_{i-1}^{-1} U_{i-1} and backward
    B_i = D_i - U_i B_{i+1}^{-1} U_i^T, the marginal is
    (T^{-1})_{ii} = (F_i + B_i - D_i)^{-1}. Two sequential sweeps of tiny
    TxT products.
    """
    N = D.shape[0]
    F = torch.empty_like(D)
    Bk = torch.empty_like(D)
    # U_shift[0] = 0, so F[0] = D[0] exactly, as the JAX scan's seed gives.
    F[0] = D[0]
    for i in range(1, N):
        F[i] = D[i] - U[i - 1].T @ _inv1(F[i - 1]) @ U[i - 1]
    # U[N-1] is structurally zero (it has no row N), so B[N-1] = D[N-1].
    Bk[N - 1] = D[N - 1]
    for i in range(N - 2, -1, -1):
        Bk[i] = D[i] - U[i] @ _inv1(Bk[i + 1]) @ U[i].T
    return _block_inv(F + Bk - D)


def marginal_covariances_all(
    poses: torch.Tensor,
    graph: FactorGraph,
) -> torch.Tensor:
    """(N, T, T) marginal covariances of EVERY pose at large-graph scale.

    Selected inverse over the chain structure + one Woodbury correction for
    the loop closures (graph.cpp:120,126-127's Marginals, for all poses):

      H^{-1} = T0^{-1} - X M^{-1} X^T,  X = T0^{-1} A^T,
      M = I + A T0^{-1} A^T

    diag_n(H^{-1}) = diag_n(T0^{-1}) - Z_n^T Z_n with Z = L_M^{-1} X^T.
    T0 solves use the sequential block-Thomas recursion batched over ALL
    T*L right-hand sides at once (each step a (T, T) @ (T, T*L) product);
    M is the only dense object, (T*L, T*L).
    """
    N, T = poses.shape[0], graph.tangent_dim
    dtype, dev = poses.dtype, poses.device
    D0, U, (li, lj, Jiw, Jjw) = _chain_prior_system(poses, graph)
    diag0 = _tridiag_selected_inverse(D0, U)
    L = li.shape[0]
    if L == 0:
        return diag0

    # A^T as dense rhs: (N, T, T*L); column block e has Jiw_e^T at row i_e,
    # Jjw_e^T at row j_e (distinct rows of distinct columns: no collision).
    AT = torch.zeros((N, T, L, T), dtype=dtype, device=dev)
    e = torch.arange(L, device=dev)
    AT[li, :, e, :] += Jiw.transpose(-1, -2)
    AT[lj, :, e, :] += Jjw.transpose(-1, -2)
    rhs = AT.reshape(N, T, L * T)

    # block-Thomas solve T0 X = rhs, batched over all L*T columns
    F_inv = torch.empty_like(D0)
    Y = torch.empty_like(rhs)
    F_inv[0] = _inv1(D0[0])
    Y[0] = rhs[0]
    for i in range(1, N):
        LT = U[i - 1].T @ F_inv[i - 1]  # L_i F_{i-1}^{-1}
        Y[i] = rhs[i] - LT @ Y[i - 1]
        F_inv[i] = _inv1(D0[i] - LT @ U[i - 1])
    # U[N-1] is structurally zero, so i=N-1 needs no look-ahead term.
    X = torch.empty_like(rhs)
    X[N - 1] = F_inv[N - 1] @ Y[N - 1]
    for i in range(N - 2, -1, -1):
        X[i] = F_inv[i] @ (Y[i] - U[i] @ X[i + 1])

    # M = I + A X: gather X at the loop endpoints and apply the J blocks.
    AX = (torch.einsum("eab,ebc->eac", Jiw, X[li])
          + torch.einsum("eab,ebc->eac", Jjw, X[lj])).reshape(L * T, L * T)
    eye = torch.eye(L * T, dtype=dtype, device=dev)
    M = eye + AX
    M = 0.5 * (M + M.T) + 1e-7 * eye
    Lm, info = torch.linalg.cholesky_ex(M)
    Lm = torch.where(info > 0, torch.full_like(Lm, float("nan")), Lm)

    # Z = Lm^{-1} X^T: one triangular solve with N*T right-hand sides.
    Z = torch.linalg.solve_triangular(Lm, X.reshape(N * T, L * T).T, upper=False)
    Zb = Z.reshape(L * T, N, T)
    corr = torch.einsum("kna,knb->nab", Zb, Zb)
    return diag0 - corr


def _hvp_columns(sys: BlockSystem, damped: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(H + damping) @ v for C vectors at once, v (N, C, T), every edge
    gathered and scattered (the JAX hvp at chain_prefix 0)."""
    out = torch.einsum("nij,ncj->nci", damped, v)
    i_idx, j_idx = sys.edges[:, 0].long(), sys.edges[:, 1].long()
    if i_idx.shape[0] > 0:
        out.index_put_((i_idx,), torch.einsum("eij,ecj->eci", sys.Aij, v[j_idx]),
                       accumulate=True)
        out.index_put_((j_idx,), torch.einsum("eji,ecj->eci", sys.Aij, v[i_idx]),
                       accumulate=True)
    return out


def marginal_covariance_cg(
    poses: torch.Tensor,
    graph: FactorGraph,
    pose_index,
    cfg: SolverConfig = SolverConfig(),
) -> torch.Tensor:
    """(T, T) marginal covariance of one pose on a large graph: T CG solves
    H x = e_col as one batch. Each column runs until its own stop (k <
    cg_max_iterations and |r|^2 > cg_tol^2 |b|^2, JAX's while_loop
    condition); its later iterations leave its state as it is."""
    lin = linearize(poses, graph)
    sys = build_blocks(lin, graph, poses.shape[0])
    N, T = sys.g.shape
    dtype, dev = poses.dtype, poses.device
    damped = _damped_diag(sys, torch.zeros((), dtype=dtype, device=dev), False)
    Minv = _block_inv(damped)
    k = torch.as_tensor(pose_index, device=dev).long().reshape(1)

    def dot(a, b):  # (C,) one per column
        return torch.sum(a * b, dim=(0, 2))

    def precond(r):
        return torch.einsum("nij,ncj->nci", Minv, r)

    cols = torch.arange(T, device=dev)
    b = torch.zeros((N, T, T), dtype=dtype, device=dev)  # (N, C, T): column c is e_(k, c)
    b.index_put_((k.expand(T), cols, cols), torch.ones(T, dtype=dtype, device=dev))
    x = torch.zeros_like(b)
    r = b - _hvp_columns(sys, damped, x)
    z = precond(r)
    p = z
    rz = dot(r, z)
    thresh = cfg.cg_tol**2 * dot(b, b)
    tiny = torch.tensor(1e-30, dtype=dtype, device=dev)
    for _ in range(cfg.cg_max_iterations):
        active = dot(r, r) > thresh
        Ap = _hvp_columns(sys, damped, p)
        alpha = rz / torch.maximum(dot(p, Ap), tiny)
        x_new = x + alpha[:, None] * p
        r_new = r - alpha[:, None] * Ap
        z = precond(r_new)
        rz_new = dot(r_new, z)
        p_new = z + (rz_new / torch.maximum(rz, tiny))[:, None] * p
        act = active[:, None]
        x = torch.where(act, x_new, x)
        r = torch.where(act, r_new, r)
        p = torch.where(act, p_new, p)
        rz = torch.where(active, rz_new, rz)
    return x.index_select(0, k)[0].T
