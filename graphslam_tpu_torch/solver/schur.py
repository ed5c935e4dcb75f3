"""Partitioned Schur-complement direct solver (domain decomposition): port of
graphslam_tpu/solver/schur.py.

The pose graph is split into contiguous index blocks; poses touched by
cross-block edges become SEPARATORS. Interior poses are eliminated
block-locally (a batched dense Cholesky over blocks), the separator normal
equations are formed as

    S = H_SS - sum_b  H_SI(b) H_II(b)^{-1} H_IS(b)

and solved densely; interiors back-substitute block-locally. With the
blocks spread over ranks, the sum over b is one all-reduce
(parallel/dist_schur.py, BASELINE config 5).

The plan (partition, separator set, per-edge scatter coordinates) is
computed on the host ONCE per graph topology in numpy, exactly as the JAX
package computes it, with each edge block's flat destination. The JAX
scatters `.at[...].add` collide where several edges land in one block;
here each is one `index_put_(accumulate=True)` at those destinations,
which sums a destination's blocks in edge order after a stable sort (on
CUDA too: no atomics), so the result has the same bits on every run. The
solutions go back into dx through integer indices made on the host, so
no step waits on the device for a mask's count. The Cholesky
factors come from `cholesky_ex`, which reads no error flag on the host; a
block that is not positive definite turns its factor into NaN, as XLA's
Cholesky does, so dx is NaN instead of an exception. Float32 throughout,
with TF32 off (the package's import): the separator complement subtracts
near-equal matrices, and a low-precision product makes it indefinite.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphslam_tpu_torch.solver.normal_eq import BlockSystem, _damped_diag


class SchurPlan(NamedTuple):
    """Host-computed static plan. B blocks, S interior slots per block
    (padded), Q separator poses (padded to q_pad)."""

    num_poses: int
    B: int
    S: int
    Q: int  # true separator count (<= q_pad)
    q_pad: int

    # Pose classification / placement.
    interior_ids: np.ndarray   # (B, S) global pose index, -1 pad
    interior_mask: np.ndarray  # (B, S)
    sep_ids: np.ndarray        # (q_pad,) global pose index, -1 pad
    sep_mask: np.ndarray       # (q_pad,)

    # Per-pose placement: block/slot for interiors, slot for separators.
    pose_block: np.ndarray     # (N,) block of interior pose, -1 if separator
    pose_slot: np.ndarray      # (N,) interior slot or separator slot

    # Per-edge scatter coordinates (E,) each; case masks select which
    # structure an edge's off-diagonal block lands in.
    e_case: np.ndarray         # (E,) 0=II, 1=IS (i int, j sep), 2=SI, 3=SS
    e_block: np.ndarray        # (E,) owning block for II/IS/SI, else 0
    e_li: np.ndarray           # (E,) interior slot of endpoint i (or 0)
    e_lj: np.ndarray           # (E,)
    e_si: np.ndarray           # (E,) separator slot of endpoint i (or 0)
    e_sj: np.ndarray           # (E,)


def schur_plan(edges: np.ndarray, num_poses: int, num_blocks: int) -> SchurPlan:
    """Partition [0, N) into `num_blocks` contiguous ranges and classify."""
    edges = np.asarray(edges)
    N = num_poses
    B = num_blocks
    size = -(-N // B)
    block_of = np.minimum(edges // size, B - 1)  # per endpoint
    pose_block_raw = np.minimum(np.arange(N) // size, B - 1)

    is_sep = np.zeros(N, bool)
    cross = block_of[:, 0] != block_of[:, 1]
    is_sep[edges[cross, 0]] = True
    is_sep[edges[cross, 1]] = True

    sep_ids_true = np.flatnonzero(is_sep)
    Q = len(sep_ids_true)
    q_pad = max(int(Q), 1)

    pose_block = np.where(is_sep, -1, pose_block_raw)
    pose_slot = np.full(N, 0, np.int64)
    interior_lists = []
    S = 0
    for b in range(B):
        ids = np.flatnonzero((pose_block == b))
        interior_lists.append(ids)
        S = max(S, len(ids))
    S = max(S, 1)
    interior_ids = np.full((B, S), -1, np.int64)
    interior_mask = np.zeros((B, S), bool)
    for b, ids in enumerate(interior_lists):
        interior_ids[b, : len(ids)] = ids
        interior_mask[b, : len(ids)] = True
        pose_slot[ids] = np.arange(len(ids))
    sep_ids = np.full(q_pad, -1, np.int64)
    sep_mask = np.zeros(q_pad, bool)
    sep_ids[:Q] = sep_ids_true
    sep_mask[:Q] = True
    pose_slot[sep_ids_true] = np.arange(Q)

    i, j = edges[:, 0], edges[:, 1]
    i_sep = is_sep[i]
    j_sep = is_sep[j]
    e_case = np.where(
        ~i_sep & ~j_sep, 0, np.where(~i_sep & j_sep, 1, np.where(i_sep & ~j_sep, 2, 3))
    )
    # Owning block: the interior endpoint's block (II edges have both in the
    # same block by construction — a cross-block edge forces separators).
    e_block = np.where(~i_sep, pose_block[i], np.where(~j_sep, pose_block[j], 0))
    e_block = np.maximum(e_block, 0)
    e_li = np.where(~i_sep, pose_slot[i], 0)
    e_lj = np.where(~j_sep, pose_slot[j], 0)
    e_si = np.where(i_sep, pose_slot[i], 0)
    e_sj = np.where(j_sep, pose_slot[j], 0)

    return SchurPlan(
        num_poses=N, B=B, S=S, Q=int(Q), q_pad=q_pad,
        interior_ids=interior_ids, interior_mask=interior_mask,
        sep_ids=sep_ids, sep_mask=sep_mask,
        pose_block=pose_block, pose_slot=pose_slot,
        e_case=e_case.astype(np.int32), e_block=e_block.astype(np.int32),
        e_li=e_li.astype(np.int32), e_lj=e_lj.astype(np.int32),
        e_si=e_si.astype(np.int32), e_sj=e_sj.astype(np.int32),
    )


# ---------------------------------------------------------------------------
# Assembly and elimination
# ---------------------------------------------------------------------------


def _rows(x: np.ndarray, device) -> torch.Tensor:
    """An int64 index array on `device`."""
    return torch.from_numpy(np.ascontiguousarray(x, np.int64)).to(device)


def _add_blocks(out: torch.Tensor, dest: torch.Tensor, vals: torch.Tensor) -> torch.Tensor:
    """out, viewed as (-1,) + vals.shape[1:], plus each row of vals at its
    flat destination `dest` (in place; returns out). index_put_ with
    accumulate sorts the destinations stably and sums each one's rows in
    their order, on CUDA too (no atomics), so the sums repeat bitwise."""
    out.view((-1,) + tuple(vals.shape[1:])).index_put_((dest,), vals, accumulate=True)
    return out


class _AssemblyIndex(NamedTuple):
    """A range of the plan's blocks as device tensors: their interiors and
    the separators, where their solutions go in dx, and where the edges'
    off-diagonal blocks go in the packed block array [HII; HIS; HSS]."""

    int_ids: torch.Tensor   # (Bl, S) interior pose, pad slots 0
    imask: torch.Tensor     # (Bl, S)
    sep_ids: torch.Tensor   # (q,) separator pose, pad slots 0
    smask: torch.Tensor     # (q,)
    int_dst: torch.Tensor   # (n,) the true interiors' poses
    int_src: torch.Tensor   # (n,) their rows of xI viewed (Bl * S, T)
    sep_dst: torch.Tensor   # (Q,) the true separators' poses
    off_rows: torch.Tensor  # the rows of [Aij; Aij^T] (2E, T, T) that are summed
    off_dest: torch.Tensor  # and their flat blocks in [HII; HIS; HSS]


def _assembly_index(plan: SchurPlan, device, blocks=None, cols=None) -> _AssemblyIndex:
    """The _AssemblyIndex of blocks [b0, b1) = `blocks` (default all) for
    the edges whose per-edge (case, block - b0, li, lj, si, sj) are `cols`
    (default the plan's own); host work, once per topology."""
    b0, b1 = (0, plan.B) if blocks is None else blocks
    S, q = plan.S, plan.q_pad
    if cols is None:
        cols = (plan.e_case, plan.e_block, plan.e_li, plan.e_lj, plan.e_si, plan.e_sj)
    case, eb, li, lj, si, sj = (np.asarray(c).astype(np.int64) for c in cols)
    E = case.shape[0]
    n_ii, n_is = (b1 - b0) * S * S, (b1 - b0) * S * q
    e0, e1, e2, e3 = (np.flatnonzero(case == k) for k in range(4))
    # case 0: Aij at (b, li, lj), Aij^T at (b, lj, li); case 1: Aij at
    # (b, li, sj); case 2: Aij^T at (b, lj, si); case 3: Aij at (si, sj),
    # Aij^T at (sj, si). Rows E + e are Aij^T's.
    rows = np.concatenate([e0, E + e0, e1, E + e2, e3, E + e3])
    dest = np.concatenate([
        (eb[e0] * S + li[e0]) * S + lj[e0], (eb[e0] * S + lj[e0]) * S + li[e0],
        n_ii + (eb[e1] * S + li[e1]) * q + sj[e1], n_ii + (eb[e2] * S + lj[e2]) * q + si[e2],
        n_ii + n_is + si[e3] * q + sj[e3], n_ii + n_is + sj[e3] * q + si[e3],
    ])
    ids = np.asarray(plan.interior_ids)[b0:b1]
    mask = np.asarray(plan.interior_mask)[b0:b1]
    return _AssemblyIndex(
        int_ids=_rows(np.maximum(ids, 0), device),
        imask=torch.from_numpy(np.ascontiguousarray(mask)).to(device),
        sep_ids=_rows(np.maximum(plan.sep_ids, 0), device),
        smask=torch.from_numpy(np.asarray(plan.sep_mask)).to(device),
        int_dst=_rows(ids[mask], device),
        int_src=_rows(np.flatnonzero(mask), device),
        sep_dst=_rows(np.asarray(plan.sep_ids)[: plan.Q], device),
        off_rows=_rows(rows, device),
        off_dest=_rows(dest, device),
    )


def _off_diag(ix: _AssemblyIndex, Aij: torch.Tensor):
    """The edges' off-diagonal blocks summed into (HII, HIS, HSS), views
    of one packed array."""
    Bl, S = ix.imask.shape
    q = ix.smask.shape[0]
    T = Aij.shape[-1]
    n_ii, n_is = Bl * S * S, Bl * S * q
    packed = Aij.new_zeros((n_ii + n_is + q * q, T, T))
    _add_blocks(packed, ix.off_dest, torch.cat([Aij, Aij.mT])[ix.off_rows])
    return (packed[:n_ii].view(Bl, S, S, T, T), packed[n_ii:n_ii + n_is].view(Bl, S, q, T, T),
            packed[n_ii + n_is:].view(q, q, T, T))


def _assemble(plan: SchurPlan, sys: BlockSystem, lam, lm_diag_scaling=True, index=None):
    """Scatter edge blocks into (HII, HIS, HSS, gI, gS)."""
    T = sys.g.shape[-1]
    B, S, q = plan.B, plan.S, plan.q_pad
    dt, dev = sys.g.dtype, sys.g.device
    ix = _assembly_index(plan, dev) if index is None else index

    HII, HIS, HSS = _off_diag(ix, sys.Aij)
    # Damped diagonal blocks placed by pose classification (no edge block
    # lands on a diagonal one: an edge joins two poses).
    damped = _damped_diag(sys, lam, lm_diag_scaling)   # (N, T, T)
    g = sys.g
    eyeT = torch.eye(T, dtype=dt, device=dev)
    bidx = torch.arange(B, device=dev)[:, None]
    sidx = torch.arange(S, device=dev)[None, :]
    # pad slots get identity -> well-conditioned
    HII[bidx, sidx, sidx] = torch.where(ix.imask[..., None, None], damped[ix.int_ids], eyeT)
    gI = torch.where(ix.imask[..., None], g[ix.int_ids], torch.zeros((), dtype=dt, device=dev))
    qidx = torch.arange(q, device=dev)
    HSS[qidx, qidx] = torch.where(ix.smask[:, None, None], damped[ix.sep_ids], eyeT)
    gS = torch.where(ix.smask[:, None], g[ix.sep_ids], torch.zeros((), dtype=dt, device=dev))
    return HII, HIS, HSS, gI, gS


def _flatten(HII, HIS, HSS, gI, gS):
    """The block arrays as matrices: A (B, ST, ST), Bm (B, ST, qT),
    C (qT, qT), bI (B, ST), bS (qT,)."""
    B, S, _, T, _ = HII.shape
    q = HSS.shape[0]
    A = HII.permute(0, 1, 3, 2, 4).reshape(B, S * T, S * T)
    Bm = HIS.permute(0, 1, 3, 2, 4).reshape(B, S * T, q * T)
    C = HSS.permute(0, 2, 1, 3).reshape(q * T, q * T)
    return A, Bm, C, -gI.reshape(B, S * T), -gS.reshape(q * T)


def _cholesky(A: torch.Tensor) -> torch.Tensor:
    """Lower Cholesky factor of (batched) A + 1e-8 I with no host read; a
    matrix that is not positive definite gets an all-NaN factor (XLA's)."""
    n = A.shape[-1]
    L, info = torch.linalg.cholesky_ex(A + 1e-8 * torch.eye(n, dtype=A.dtype, device=A.device))
    return torch.where((info > 0)[..., None, None], torch.full_like(L, float("nan")), L)


def _chol_solve(L: torch.Tensor, rhs: torch.Tensor) -> torch.Tensor:
    """(L L^T)^{-1} rhs by the two triangular solves."""
    y = torch.linalg.solve_triangular(L, rhs, upper=False)
    return torch.linalg.solve_triangular(L.mT, y, upper=True)


def block_eliminate(A, Bm, bI):
    """Per-block Cholesky and the two triangular solves: W = A^{-1} Bm,
    u = A^{-1} bI."""
    L = _cholesky(A)
    return _chol_solve(L, Bm), _chol_solve(L, bI[..., None])[..., 0]


def separator_products(Bm, W, u):
    """sum_b Bm_b^T W_b (qT, qT) and sum_b Bm_b^T u_b (qT,)."""
    qT = Bm.shape[-1]
    Bf = Bm.reshape(-1, qT)
    return Bf.T @ W.reshape(-1, qT), Bf.T @ u.reshape(-1)


def separator_solve(S_hat, rhs_hat):
    """xS from the separator system."""
    Ls = _cholesky(S_hat)
    return _chol_solve(Ls, rhs_hat[:, None])[:, 0]


def _no_mark(stage: str) -> None:
    pass


def _eliminate(A, Bm, bI, C, bS, all_reduce=None, mark=_no_mark):
    """Interior elimination and the separator solve: (xI (B, ST), xS (qT,)).
    `all_reduce` sums the packed separator products over the ranks that
    hold the other blocks (parallel/dist_schur.py); `mark(stage)` is called
    after each stage (a timer's hook)."""
    W, u = block_eliminate(A, Bm, bI)
    mark("block_cholesky")
    S_part, r_part = separator_products(Bm, W, u)
    mark("separator_products")
    if all_reduce is not None:
        qT = C.shape[-1]
        buf = all_reduce(torch.cat([S_part.reshape(-1), r_part]))
        S_part, r_part = buf[: qT * qT].reshape(qT, qT), buf[qT * qT:]
        mark("all_reduce_separator")
    xS = separator_solve(C - S_part, bS - r_part)
    mark("separator_cholesky")
    # Back-substitute interiors: xI = u - W xS.
    xI = u - W @ xS
    mark("back_substitution")
    return xI, xS


def _scatter_dx(num_poses, ix: _AssemblyIndex, xI, xS):
    """dx (N, T) from the interiors' and the separators' solutions."""
    T = xS.shape[0] // ix.smask.shape[0]
    dx = torch.zeros((num_poses, T), dtype=xS.dtype, device=xS.device)
    dx[ix.int_dst] = xI.reshape(-1, T)[ix.int_src]
    dx[ix.sep_dst] = xS.reshape(-1, T)[: ix.sep_dst.shape[0]]
    return dx


def schur_solve(
    plan: SchurPlan,
    sys: BlockSystem,
    lam,
    lm_diag_scaling: bool = True,
) -> torch.Tensor:
    """Direct solve of (H + damping) dx = -g via block elimination.

    Returns dx (N, T)."""
    ix = _assembly_index(plan, sys.g.device)
    A, Bm, C, bI, bS = _flatten(*_assemble(plan, sys, lam, lm_diag_scaling, ix))
    xI, xS = _eliminate(A, Bm, bI, C, bS)
    return _scatter_dx(plan.num_poses, ix, xI, xS)
