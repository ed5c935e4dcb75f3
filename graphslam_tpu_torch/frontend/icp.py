"""GICP-class SE(2) scan matcher: port of graphslam_tpu/frontend/icp.py.

Correspondences are brute-force nearest valid targets on exact coordinate
differences; per-point surfel covariances come from a fixed half-window
line fit along the (angularly ordered) scan; the IRLS Gauss-Newton on the
3-dof SE(2) delta weights each residual by M = (C_t + R C_s R^T + eps I)^-1.

`gicp_match` picks its path from the tensors' device, as the JAX one picks
the Pallas kernel from the backend: CUDA tensors run the whole IRLS loop in
the hand-written kernel (ops/icp_kernel.py::fused_icp_loop, no host
synchronization inside); CPU tensors run the plain torch path, the port of
the JAX XLA path. `use_kernel` overrides the choice, as `use_pallas` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from graphslam_tpu_torch.geometry import se2, so2


class MatchResult(NamedTuple):
    delta: torch.Tensor         # (3,) SE(2) source->target transform estimate
    fitness: torch.Tensor       # () mean squared NN distance over all valid
                                #    source points, ungated (PCL fitness)
    inlier_rms: torch.Tensor    # () RMS distance over gated correspondences
    matched_frac: torch.Tensor  # () fraction of source points with a match
    converged: torch.Tensor     # () bool: final GN update below tolerance
    mahal_rmse: torch.Tensor    # () sqrt(mean Mahalanobis residual)
    degenerate: torch.Tensor    # () bool: the 3x3 GN Hessian is rank-deficient
    hessian: torch.Tensor       # (3, 3) final IRLS Hessian J^T M J


_SCAN_BLOCK = 16


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum over dim 0, in float32 and in the order XLA's
    CPU cumsum adds: left to right inside blocks of 16, the block totals
    scanned the same way (recursively) and added back. The windowed sums
    below cancel (c[hi] - c[lo] of large prefix sums), and a near-isotropic
    window's normal turns with that roundoff, so the port keeps the JAX
    package's order: on the CPU the two agree bit for bit. torch.cumsum
    would not (it accumulates float32 in float64 on the CPU, and in an
    order that may vary between runs on CUDA)."""
    n = x.shape[0]
    pad = (-n) % _SCAN_BLOCK
    xb = torch.nn.functional.pad(x, (0, 0) * (x.ndim - 1) + (0, pad))
    xb = xb.reshape(-1, _SCAN_BLOCK, *x.shape[1:])
    for i in range(1, min(_SCAN_BLOCK, n)):
        xb[:, i] += xb[:, i - 1]
    if xb.shape[0] > 1:
        xb[1:] += _prefix_sum(xb[:, -1])[:-1, None]
    return xb.reshape(-1, *x.shape[1:])[:n]


def estimate_normals(points: torch.Tensor, mask: torch.Tensor, half_window: int):
    """Windowed line fit along the scan: (normals (P, 2), covs (P, 2, 2)),
    with prefix sums over the beam axis."""
    P = points.shape[0]
    w = mask.to(points.dtype)[:, None]
    pw = points * w
    idx = torch.arange(P, device=points.device)
    lo = torch.clamp(idx - half_window, 0, P)
    hi = torch.clamp(idx + half_window + 1, 0, P)

    # Count, sum and outer-product sum in one scan (columns are independent).
    outer = (pw[:, :, None] * points[:, None, :]).reshape(P, 4)
    c = _prefix_sum(torch.cat([w, pw, outer], dim=1))
    c = torch.cat([torch.zeros_like(c[:1]), c], dim=0)  # (P+1, 7)
    win = c[hi] - c[lo]
    n = win[:, 0:1]                         # (P, 1) count
    s1 = win[:, 1:3]                        # (P, 2) sum
    s2 = win[:, 3:].reshape(P, 2, 2)

    n_safe = torch.clamp(n, min=1.0)
    mean = s1 / n_safe
    cov = s2 / n_safe[..., None] - mean[:, :, None] * mean[:, None, :]
    cov = cov + 1e-8 * torch.eye(2, dtype=points.dtype, device=points.device)

    # Closed-form 2x2 eigendecomposition; normal = minor eigenvector.
    a, b, c_ = cov[:, 0, 0], cov[:, 0, 1], cov[:, 1, 1]
    tr = a + c_
    det_half = torch.sqrt(torch.clamp(((a - c_) / 2) ** 2 + b * b, min=1e-20))
    lam_min = tr / 2 - det_half
    v1 = torch.stack([b, lam_min - a], dim=-1)
    v2 = torch.stack([lam_min - c_, b], dim=-1)
    use_v1 = torch.sum(v1 * v1, dim=-1) > torch.sum(v2 * v2, dim=-1)
    v = torch.where(use_v1[:, None], v1, v2)
    norm = torch.sqrt(torch.clamp(torch.sum(v * v, dim=-1, keepdim=True), min=1e-20))
    return v / norm, cov


def surfel_covs(points, mask, half_window: int, eps: float) -> torch.Tensor:
    """GICP covariances: unit variance along the fitted line, eps across."""
    n, _ = estimate_normals(points, mask, half_window)
    t = torch.stack([-n[:, 1], n[:, 0]], dim=-1)  # tangent
    return t[:, :, None] * t[:, None, :] + eps * (n[:, :, None] * n[:, None, :])


def _det3(A: torch.Tensor) -> torch.Tensor:
    """Determinant of (..., 3, 3) by cofactors (no LU, no host sync)."""
    return (
        A[..., 0, 0] * (A[..., 1, 1] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 1])
        - A[..., 0, 1] * (A[..., 1, 0] * A[..., 2, 2] - A[..., 1, 2] * A[..., 2, 0])
        + A[..., 0, 2] * (A[..., 1, 0] * A[..., 2, 1] - A[..., 1, 1] * A[..., 2, 0])
    )


def _sym3x3_eigvals(A: torch.Tensor) -> torch.Tensor:
    """Eigenvalues of a symmetric 3x3 (ascending), closed trigonometric form
    (Smith's algorithm), branch-free."""
    q = torch.diagonal(A).sum() / 3.0
    B = A - q * torch.eye(3, dtype=A.dtype, device=A.device)
    p2 = torch.sum(B * B) / 6.0
    p = torch.sqrt(torch.clamp(p2, min=1e-30))
    r = torch.clamp(_det3(B / p) / 2.0, -1.0, 1.0)
    phi = torch.arccos(r) / 3.0
    e1 = q + 2.0 * p * torch.cos(phi)
    e3 = q + 2.0 * p * torch.cos(phi + 2.0 * torch.pi / 3.0)
    e2 = 3.0 * q - e1 - e3
    return torch.stack([e3, e2, e1])


def _pairwise_sqdist(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(Na,2),(Nb,2) -> (Na,Nb) squared distances, exact coordinate
    differences (never the ||a||^2+||b||^2-2ab product form)."""
    dx = a[:, 0:1] - b[None, :, 0]
    dy = a[:, 1:2] - b[None, :, 1]
    return dx * dx + dy * dy


def _plain_step(delta, src_pts, src_mask, tgt_pts, invalid_t, Ct, Cs, max_corr_dist):
    """One IRLS iteration of the plain path (icp.py:213-249): (new delta,
    (sum_d2_all, sum_d2, n_match, sum_mahal, |upd|, H))."""
    dtype, dev = src_pts.dtype, src_pts.device
    moved = se2.transform(delta, src_pts)
    c, s = torch.cos(delta[2]), torch.sin(delta[2])
    dR = torch.stack([torch.stack([-s, -c]), torch.stack([c, -s])])
    jtheta = src_pts @ dR.T                                 # (P, 2)

    d2 = _pairwise_sqdist(moved, tgt_pts)
    d2 = torch.where(invalid_t[None, :], torch.full_like(d2, 1e9), d2)
    nn = torch.argmin(d2, dim=1)
    nn_d2 = torch.gather(d2, 1, nn[:, None])[:, 0]
    wv = (src_mask & (nn_d2 <= max_corr_dist**2)).to(dtype)

    q = tgt_pts[nn]
    R = so2.rotmat(delta[2])
    Csr = torch.einsum("ab,nbc,dc->nad", R, Cs, R)
    eye2 = torch.eye(2, dtype=dtype, device=dev)
    M = torch.linalg.inv_ex(Ct[nn] + Csr + 1e-6 * eye2)[0]

    e = q - moved                                           # (P, 2)
    J = torch.cat([eye2.expand(src_pts.shape[0], 2, 2), jtheta[:, :, None]], dim=-1)
    MJ = torch.einsum("nab,nbc->nac", M, J)
    H = torch.einsum("nba,nbc,n->ac", J, MJ, wv) + 1e-6 * torch.eye(3, dtype=dtype, device=dev)
    g = torch.einsum("nba,nbc,nc->a", J, M, e * wv[:, None])
    upd = torch.linalg.solve_ex(H, g)[0]
    new_delta = torch.cat([delta[:2] + upd[:2], so2.wrap(delta[2] + upd[2])[None]])
    wall = src_mask.to(dtype)
    stats = (
        torch.sum(nn_d2 * wall),  # ungated (PCL fitness numerator)
        torch.sum(nn_d2 * wv),
        torch.sum(wv),
        torch.sum(torch.einsum("na,nab,nb->n", e, M, e) * wv),
        torch.linalg.vector_norm(upd),
        H,
    )
    return new_delta, stats


def gicp_match(
    src_pts: torch.Tensor,
    src_mask: torch.Tensor,
    tgt_pts: torch.Tensor,
    tgt_mask: torch.Tensor,
    init_delta: Optional[torch.Tensor] = None,
    iterations: int = 16,
    max_corr_dist: float = 1.0,
    half_window: int = 4,
    gicp_eps: float = 1e-3,
    tol: float = 1e-5,
    degeneracy_ratio: float = 1e-3,
    use_kernel: Optional[bool] = None,
    early_exit: bool = True,
) -> MatchResult:
    """Estimate the SE(2) transform mapping the source scan into the target
    frame; masked points never contribute.

    use_kernel: run the IRLS loop through ops/icp_kernel.py::fused_icp_loop
    (CUDA tensors only); False runs the plain path on either device.
    None = by device: the kernel for CUDA tensors, the plain path for CPU.
    early_exit: stop once |upd| < tol (the default, as in the JAX package);
    False runs all `iterations`."""
    dtype, dev = src_pts.dtype, src_pts.device
    delta0 = torch.zeros(3, dtype=dtype, device=dev) if init_delta is None else init_delta
    if use_kernel is None:
        use_kernel = dev.type == "cuda"

    Ct = surfel_covs(tgt_pts, tgt_mask, half_window, gicp_eps)
    Cs = surfel_covs(src_pts, src_mask, half_window, gicp_eps)

    if use_kernel:
        from graphslam_tpu_torch.ops.icp_kernel import fused_icp_loop

        delta, H_last, st, last_upd = fused_icp_loop(
            src_pts, src_mask, tgt_pts, tgt_mask, Cs, Ct, delta0, iterations,
            max_corr2=float(max_corr_dist) ** 2, eps=1e-6, tol=tol, early_exit=early_exit,
        )
        sum_d2_all, sum_d2, n_match, sum_mahal = st[0], st[1], st[2], st[3]
    else:
        invalid_t = ~tgt_mask
        delta = delta0
        for k in range(iterations):
            delta, stats = _plain_step(delta, src_pts, src_mask, tgt_pts, invalid_t, Ct, Cs,
                                       max_corr_dist)
            # while_loop's cond (icp.py:260-262); a NaN update stops it
            if early_exit and not bool(stats[4] >= tol):
                break
        sum_d2_all, sum_d2, n_match, sum_mahal, last_upd, H_last = stats

    # Degeneracy: the smallest Hessian eigenvalue against the largest.
    eigs = _sym3x3_eigvals(H_last)
    n_src = torch.clamp(src_mask.to(dtype).sum(), min=1.0)
    n_safe = torch.clamp(n_match, min=1.0)
    return MatchResult(
        delta=delta,
        fitness=sum_d2_all / n_src,
        inlier_rms=torch.sqrt(sum_d2 / n_safe),
        matched_frac=n_match / n_src,
        converged=last_upd < tol,
        mahal_rmse=torch.sqrt(sum_mahal / n_safe),
        degenerate=eigs[0] < degeneracy_ratio * eigs[2],
        hessian=H_last,
    )
