"""The reference solve: Gauss-Newton or Levenberg-Marquardt on the map's
pose graph, in float64, by the method the mix states.

It works everything out again from the map's numpy arrays: the whitening
(a Cholesky of each information matrix), the residuals Log(z^-1 x_i^-1
x_j), their Jacobians (forward-mode differentiation of the residual in the
two endpoints' tangents, not a formula), the Huber weights on the loop
edges, and the normal equations as one dense matrix. The prior anchors
pose 0 at its odometry guess with sigma 0.1. The step solves them by
  "dense"  a dense Cholesky (the exact step);
  "schur"  eliminating the interiors of contiguous blocks of poses first,
           the partitioned method written from its equations (exact too);
  "pcg"    a fixed count of conjugate-gradient iterations from zero,
           preconditioned by parallel cyclic reduction (PCR) of the
           block-tridiagonal part of the matrix (its diagonal blocks and
           the blocks between poses k and k+1), eliminating couplings up
           to distance 2^levels (all of them: the exact tridiagonal solve),
           each level's diagonal blocks first given the ridge
           + (eps / T |trace| + 1e-8) I. This is the fused kernels' method;
           its step is not the exact one, so the loop it drives reaches
           another point than an exact one would in as many iterations.
The loop is the mix's: GN with optional Marquardt damping (H + lam
diag(H)), or LM with the classic schedule (a step is accepted when the cost
falls; lam divided or multiplied by its factor), a fixed number of steps
with no early exit.
"""

from __future__ import annotations

import math

import numpy as np
import torch
from torch.func import jacfwd, vmap

from benchmark.reference.lie import group
from benchmark.reference.precision import Precision

PRIOR_SIGMA = 0.1


class Problem:
    """The map's factors on `device`. Residuals and Jacobians are worked out
    in float64 and then kept in `prec`; the normal equations and their solve
    are in `prec.dtype`."""

    def __init__(self, data: dict, device, prec: Precision):
        self.prec = prec
        dt = torch.float64
        self.G = group(np.asarray(data["poses"]).shape[-1])
        T = self.G.tangent
        self.T, self.N = T, int(np.asarray(data["poses"]).shape[0])
        edges = np.asarray(data["edges"], np.int64)
        info = np.asarray(data["information"], np.float64)
        upper = np.swapaxes(np.linalg.cholesky(info), -1, -2)     # info = U^T U

        def t(a, dtype=dt):
            return torch.as_tensor(np.asarray(a), device=device).to(dtype)

        self.i, self.j = t(edges[:, 0], torch.long), t(edges[:, 1], torch.long)
        self.z, self.U = t(data["measurements"]), t(upper)
        self.is_loop = t(data["is_loop"], torch.bool)
        self.x0 = t(data["poses"])
        self.prior_z = self.x0[0]
        self.prior_U = torch.eye(T, dtype=dt, device=device) / PRIOR_SIGMA

    def _edge_res(self, xi, xj, z, U, di, dj):
        G = self.G
        h = G.between(G.compose(xi, G.exp(di)), G.compose(xj, G.exp(dj)))
        return U @ G.log(G.between(z, h))

    def _prior_res(self, x, d):
        G = self.G
        return self.prior_U @ G.log(G.between(self.prior_z, G.compose(x, G.exp(d))))

    def residuals(self, x):
        """Whitened edge residuals (E, T) and the prior's (T,), in float64."""
        x = x.double()
        zero = torch.zeros((self.i.shape[0], self.T), dtype=x.dtype, device=x.device)
        r = vmap(self._edge_res)(x[self.i], x[self.j], self.z, self.U, zero, zero)
        return r, self._prior_res(x[0], zero[0])

    def cost(self, x, huber):
        """Sum of squared whitened residuals, Huber's rho on the loops,
        each term and the sum kept in `prec`."""
        r, rp = self.residuals(x)
        e = (r * r).sum(-1)
        if huber is not None:
            n = torch.sqrt(torch.clamp(e, min=1e-24))
            e = torch.where(self.is_loop, torch.where(n <= huber, e, 2 * huber * n - huber ** 2), e)
        terms = torch.cat([e, (rp * rp).sum()[None]]).to(self.prec.dtype)
        if self.prec.name == "bf16":
            return self.prec.store(terms).to(torch.bfloat16).sum().to(torch.float64)
        return terms.sum().to(torch.float64)

    def normal_equations(self, x, huber):
        """(H dense (NT, NT), g (NT,)) of the (Huber-weighted) residuals."""
        p, T, N = self.prec, self.T, self.N
        x = x.double()
        zero = torch.zeros((self.i.shape[0], T), dtype=x.dtype, device=x.device)
        jac = vmap(jacfwd(self._edge_res, argnums=(4, 5)))
        Ji, Jj = jac(x[self.i], x[self.j], self.z, self.U, zero, zero)
        r, rp = self.residuals(x)
        Jp = jacfwd(self._prior_res, argnums=1)(x[0], zero[0])
        if huber is not None:
            n = r.norm(dim=-1)
            w = torch.sqrt(torch.clamp(huber / torch.clamp(n, min=1e-12), max=1.0))
            w = torch.where(self.is_loop, w, torch.ones_like(w))
            r, Ji, Jj = r * w[:, None], Ji * w[:, None, None], Jj * w[:, None, None]
        r, Ji, Jj, rp, Jp = (p.store(a.to(p.dtype)) for a in (r, Ji, Jj, rp, Jp))
        blocks = [
            (self.i, self.i, p.einsum("eki,ekj->eij", Ji, Ji)),
            (self.j, self.j, p.einsum("eki,ekj->eij", Jj, Jj)),
            (self.i, self.j, p.einsum("eki,ekj->eij", Ji, Jj)),
            (self.j, self.i, p.einsum("eki,ekj->eij", Jj, Ji)),
            (self.i[:1] * 0, self.i[:1] * 0, p.einsum("ki,kj->ij", Jp, Jp)[None]),
        ]
        H = torch.zeros((N * T, N * T), dtype=p.dtype, device=x.device)
        ar = torch.arange(T, device=x.device)
        for a, b, blk in blocks:
            rows = (a[:, None, None] * T + ar[None, :, None]).expand(blk.shape)
            cols = (b[:, None, None] * T + ar[None, None, :]).expand(blk.shape)
            H.index_put_((rows.reshape(-1), cols.reshape(-1)), p.store(blk).reshape(-1),
                         accumulate=True)
        g = torch.zeros((N, T), dtype=p.dtype, device=x.device)
        g.index_add_(0, self.i, p.store(p.einsum("eki,ek->ei", Ji, r)))
        g.index_add_(0, self.j, p.store(p.einsum("eki,ek->ei", Jj, r)))
        g[0] += p.store(p.einsum("ki,k->i", Jp, rp))
        return H, g.reshape(-1)

    def retract(self, x, dx):
        x = self.G.compose(x.double(), self.G.exp(dx.double().reshape(self.N, self.T)))
        return self.prec.store(x.to(self.prec.dtype))


def _chol_solve(A, rhs):
    """A^{-1} rhs by Cholesky; NaN where A is not positive definite."""
    L, info = torch.linalg.cholesky_ex(A)
    out = torch.cholesky_solve(rhs, L)
    return torch.where((info > 0)[..., None, None], torch.full_like(out, float("nan")), out)


def dense_step(H, g, prob, plan=None):
    return prob.prec.store(_chol_solve(H, -g[:, None])[:, 0])


def schur_plan(edges: np.ndarray, N: int, blocks: int):
    """Contiguous blocks of poses; the endpoints of edges across blocks are
    the separators. Returns (interior pose ids of each block, separator ids)."""
    size = -(-N // blocks)
    block_of = np.minimum(np.arange(N) // size, blocks - 1)
    e = np.asarray(edges, np.int64)
    cross = block_of[e[:, 0]] != block_of[e[:, 1]]
    sep = np.zeros(N, bool)
    sep[e[cross].reshape(-1)] = True
    interiors = [np.flatnonzero((block_of == b) & ~sep) for b in range(blocks)]
    return interiors, np.flatnonzero(sep)


def schur_step(H, g, prob, plan):
    """The step by block elimination: S = C - sum_b B_b^T A_b^{-1} B_b."""
    p, T = prob.prec, prob.T
    interiors, sep = plan

    def rows(ids):
        return torch.as_tensor((ids[:, None] * T + np.arange(T)).reshape(-1), device=H.device)

    s = rows(sep)
    S = H[s][:, s].clone()
    rS = -g[s]
    parts = []
    for ids in interiors:
        if len(ids) == 0:
            continue
        ii = rows(ids)
        A, Bb = H[ii][:, ii], H[ii][:, s]
        L, info = torch.linalg.cholesky_ex(A)
        W = p.store(torch.cholesky_solve(Bb, L))
        u = p.store(torch.cholesky_solve(-g[ii][:, None], L))
        bad = bool(info > 0)
        S = S - p.operand(Bb.T) @ p.operand(W)
        rS = rS - (p.operand(Bb.T) @ p.operand(u))[:, 0]
        parts.append((ii, W, u, bad))
    xS = p.store(_chol_solve(p.store(S), rS[:, None])[:, 0])
    dx = torch.zeros_like(g)
    dx[s] = xS
    for ii, W, u, bad in parts:
        xI = u[:, 0] - (p.operand(W) @ p.operand(xS[:, None]))[:, 0]
        dx[ii] = torch.full_like(xI, float("nan")) if bad else xI
    return p.store(dx)


def _shift(X, s: int):
    """Y[n] = X[n - s], zero where n - s is outside."""
    Y = torch.zeros_like(X)
    n = X.shape[0]
    if abs(s) < n:
        if s > 0:
            Y[s:] = X[:n - s]
        else:
            Y[:n + s] = X[-s:]
    return Y


def _ridge(D, eps: float):
    T = D.shape[-1]
    tr = torch.diagonal(D, dim1=-2, dim2=-1).sum(-1).abs()
    return D + ((eps / T) * tr + 1e-8)[:, None, None] * torch.eye(T, dtype=D.dtype, device=D.device)


def pcr_preconditioner(H, T: int, levels, eps: float, prec: Precision):
    """z = P^{-1} r by K levels of PCR on the block-tridiagonal part of H."""
    N = H.shape[0] // T
    blocks = H.reshape(N, T, N, T).permute(0, 2, 1, 3)
    idx = torch.arange(N, device=H.device)
    D = blocks[idx, idx].clone()
    U = torch.zeros_like(D)
    U[:-1] = blocks[idx[:-1], idx[:-1] + 1]
    L = _shift(U.transpose(-1, -2), 1)
    K = int(levels) if levels is not None else math.ceil(math.log2(N))
    steps = []
    for k in range(K):
        h = 1 << k
        D = _ridge(D, eps)
        Dinv = torch.linalg.inv(D)
        alpha = prec.store(L @ _shift(Dinv, h))
        gamma = prec.store(U @ _shift(Dinv, -h))
        steps.append((h, alpha, gamma))
        D = D - alpha @ _shift(U, h) - gamma @ _shift(L, -h)
        L = -alpha @ _shift(L, h)
        U = -gamma @ _shift(U, -h)
    Dinv = prec.store(torch.linalg.inv(_ridge(D, eps)))

    def apply(r):
        b = r.reshape(N, T)
        for h, alpha, gamma in steps:
            b = b - (alpha @ _shift(b, h)[..., None])[..., 0] - (gamma @ _shift(b, -h)[..., None])[..., 0]
        return (Dinv @ b[..., None])[..., 0].reshape(-1)

    return apply


def pcg_step(H, g, prob, plan):
    """A fixed count of PCG iterations from zero on H x = -g; a step whose
    curvature p^T H p is not positive (below 1e-30) moves nothing."""
    p_, cg, levels, eps = prob.prec, plan["cg"], plan["pcr_levels"], plan["pcr_eps"]
    P = pcr_preconditioner(H, prob.T, levels, eps, p_)
    b = -g
    x = torch.zeros_like(b)
    r = b
    z = P(r)
    p = z
    rz = r @ z
    tiny = 1e-30
    for _ in range(cg):
        Ap = H @ p
        pAp = p @ Ap
        alpha = torch.where(pAp > tiny, rz / torch.clamp(pAp, min=tiny), 0.0)
        x = x + alpha * p
        r = r - alpha * Ap
        z = P(r)
        rz_new = r @ z
        beta = torch.where(rz > tiny, rz_new / torch.clamp(rz, min=tiny), 0.0)
        p = z + beta * p
        rz = rz_new
    return p_.store(x)


STEPS = {"dense": dense_step, "schur": schur_step, "pcg": pcg_step}


def solve(data: dict, ref: dict, device, precision: str = "float64") -> dict:
    """Run the reference loop described by the traffic's `reference`
    parameters on the map `data`: {"poses" (N, D) float64 numpy, "cost",
    "accepted" (LM only)}.

    ref: {"method": "gn" | "lm", "iterations", "huber" (delta or null),
    "solve": "dense" | "schur" | "pcg", "blocks" (schur), "cg",
    "pcr_levels" (null: all), "pcr_eps" (pcg), "lam" (GN's Marquardt
    damping, 0 for none), "lam0", "lam_factor", "lam_min", "lam_max" (LM)}.
    """
    prec = Precision(precision)
    with prec.matmul_mode():
        return _solve(data, ref, device, prec)


def _solve(data: dict, ref: dict, device, prec: Precision) -> dict:
    prob = Problem(data, device, prec)
    huber = ref.get("huber")
    step = STEPS[ref["solve"]]
    plan = (schur_plan(data["edges"], prob.N, ref["blocks"]) if ref["solve"] == "schur" else
            {k: ref.get(k) for k in ("cg", "pcr_levels", "pcr_eps")})
    x = prec.store(prob.x0.to(prec.dtype))
    accepted = 0
    if ref["method"] == "gn":
        for _ in range(ref["iterations"]):
            H, g = prob.normal_equations(x, huber)
            if ref.get("lam", 0.0):
                H = H + ref["lam"] * torch.diag(torch.diagonal(H))
            x = prob.retract(x, step(H, g, prob, plan))
        err = prob.cost(x, huber)
    else:
        lam = ref["lam0"]
        err = prob.cost(x, huber)
        H = g = None
        for _ in range(ref["iterations"]):
            if H is None:
                H, g = prob.normal_equations(x, huber)
            Hd = H + lam * torch.diag(torch.diagonal(H))
            cand = prob.retract(x, step(Hd, g, prob, plan))
            new = prob.cost(cand, huber)
            if bool(new < err):
                x, err, H, accepted = cand, new, None, accepted + 1
                lam = max(lam / ref["lam_factor"], ref["lam_min"])
            else:
                lam = min(lam * ref["lam_factor"], ref["lam_max"])
    return {"poses": x.double().cpu().numpy(), "cost": float(err), "accepted": accepted}


def cost_at(data: dict, poses: np.ndarray, huber, device) -> float:
    """The float64 cost of the map at `poses`."""
    prob = Problem(data, device, Precision("float64"))
    x = torch.as_tensor(np.asarray(poses, np.float64), device=device)
    return float(prob.cost(x, huber))


def ate(poses: np.ndarray, gt: np.ndarray, dim: int) -> float:
    """RMS translation error against the ground truth (no alignment: pose 0
    is anchored)."""
    G = group(dim)
    d = G.translation(torch.as_tensor(poses)) - G.translation(torch.as_tensor(gt, dtype=torch.float64))
    return math.sqrt(float((d * d).sum(-1).mean()))
