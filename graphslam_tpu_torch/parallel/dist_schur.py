"""Rank-sharded partitioned Schur reduction (BASELINE config 5): port of
graphslam_tpu/parallel/dist_schur.py.

The SchurPlan's blocks are spread over the ranks of a Mesh
(parallel/dist.py): every rank assembles and factorizes only ITS blocks'
interior systems (batched dense Cholesky), the separator normal equations
are combined with one all-reduce, each rank solves the (replicated)
separator system redundantly, and interiors back-substitute locally.

Each `psum` of the JAX body is one all-reduce of one packed buffer:
  * dist_schur_solve: the separator products [S_part; r_part] (JAX's two
    psums), then dx_part, which gathers the interiors' dx (JAX's sharded
    out_spec): 2 all-reduces a solve;
  * dist_schur_gn_solve: [diagS; gS; HSSo], the separator products, and
    dx_part: 3 all-reduces a GN iteration. The GN loop is a Python loop
    over iterations that reads nothing back to the host: every scatter
    and gather takes integer indices made on the host once per topology.
The collided scatters are index_put_ sums at those indices
(solver/schur.py::_add_blocks), so a rank's sums have the same bits on
every run.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphslam_tpu_torch.factors.linearize import linearize_edges, linearize_priors
from graphslam_tpu_torch.parallel.dist import Mesh
from graphslam_tpu_torch.solver.lm import _retract_all
from graphslam_tpu_torch.solver.normal_eq import BlockSystem
from graphslam_tpu_torch.solver.schur import (
    SchurPlan,
    _add_blocks,
    _AssemblyIndex,
    _assemble,
    _assembly_index,
    _eliminate,
    _flatten,
    _no_mark,
    _off_diag,
    _rows,
)


def pad_plan(plan: SchurPlan, n_dev: int) -> SchurPlan:
    """Pad the block axis to a multiple of the mesh size (padded blocks have
    no interiors: mask all-false, identity diagonals)."""
    B = plan.B
    pad = (-B) % n_dev
    if pad == 0:
        return plan
    return plan._replace(
        B=B + pad,
        interior_ids=np.concatenate(
            [plan.interior_ids, np.full((pad, plan.S), -1, plan.interior_ids.dtype)]
        ),
        interior_mask=np.concatenate(
            [plan.interior_mask, np.zeros((pad, plan.S), bool)]
        ),
    )


def _gather_interiors(num_poses, mesh: Mesh, ix, xI, T):
    """dx_part (N, T): the interiors' dx of the blocks of `ix` (an
    _AssemblyIndex), zero elsewhere, summed over the ranks (one
    all-reduce). The ranks' interiors are disjoint, so the sum is exact."""
    dx = torch.zeros((num_poses, T), dtype=xI.dtype, device=xI.device)
    dx[ix.int_dst] = xI.reshape(-1, T)[ix.int_src]
    return mesh.all_reduce(dx)


def dist_schur_solve(
    plan: SchurPlan,
    sys: BlockSystem,
    lam,
    mesh: Mesh,
    axis: str = "dev",
    lm_diag_scaling: bool = True,
) -> torch.Tensor:
    """Distributed version of solver.schur.schur_solve. The assembly runs
    replicated (cheap scatter work over edges); the expensive per-block
    factorizations and Schur products run on each rank's blocks. At world
    size 1 it is schur_solve, bit for bit. `axis` is the JAX signature's
    mesh axis: a Mesh here has the one."""
    plan = pad_plan(plan, mesh.size)
    N, T = sys.g.shape
    ix = _assembly_index(plan, sys.g.device)
    A, Bm, C, bI, bS = _flatten(*_assemble(plan, sys, lam, lm_diag_scaling, ix))
    Bpd = plan.B // mesh.size
    b0, b1 = mesh.rank * Bpd, (mesh.rank + 1) * Bpd
    xI, xS = _eliminate(A[b0:b1], Bm[b0:b1], bI[b0:b1], C, bS, all_reduce=mesh.all_reduce)
    own = _assembly_index(plan, sys.g.device, blocks=(b0, b1), cols=_no_edges())
    dx = _gather_interiors(N, mesh, own, xI, T)
    dx[ix.sep_dst] += xS.reshape(-1, T)[: ix.sep_dst.shape[0]]
    return dx


def shard_schur_edges(graph, plan: SchurPlan, n_dev: int):
    """Host-side edge partition for the fully-sharded GN loop: every edge is
    assigned to the rank owning its interior block (cross-separator SS
    edges round-robin), per-rank lists padded to equal length with masked
    dummies. Returns (padded_plan, dict of (n_dev*Epd, ...) tensors on the
    graph's device, laid out rank-contiguously: rank r holds rows
    [r*Epd, (r+1)*Epd))."""
    plan, shard = _shard_numpy(graph, plan, n_dev)
    return plan, {k: torch.from_numpy(v).to(graph.device) for k, v in shard.items()}


def _shard_numpy(graph, plan: SchurPlan, n_dev: int):
    """shard_schur_edges with numpy arrays (the graph read to the host once)."""
    plan = pad_plan(plan, n_dev)
    Bpd = plan.B // n_dev
    e_case = np.asarray(plan.e_case)
    e_block = np.asarray(plan.e_block)
    E = e_block.shape[0]
    dev_e = np.where(e_case == 3, np.arange(E) % n_dev, e_block // Bpd)
    counts = np.bincount(dev_e, minlength=n_dev)
    Epd = max(int(counts.max()), 1)
    idx = np.full((n_dev, Epd), -1, np.int64)
    for d in range(n_dev):
        ids = np.flatnonzero(dev_e == d)
        idx[d, : len(ids)] = ids
    flat = idx.reshape(-1)
    pad = flat < 0
    safe = np.maximum(flat, 0)

    def take(x, zero_pad=True):
        arr = np.array((x.cpu().numpy() if torch.is_tensor(x) else np.asarray(x))[safe])
        if zero_pad:
            arr[pad] = 0
        return arr

    emask = take(graph.edge_mask)
    emask[pad] = False
    eb_loc = np.clip(
        take(plan.e_block) - np.repeat(np.arange(n_dev), Epd) * Bpd,
        0, Bpd - 1,
    )
    shard = {
        "edges": np.clip(take(graph.edges), 0, plan.num_poses - 1),
        "meas": take(graph.measurements),
        "sq": take(graph.sqrt_info),
        "emask": emask,
        "iloop": take(graph.is_loop),
        "ecase": take(plan.e_case),
        "ebl": eb_loc.astype(np.int32),
        "eli": take(plan.e_li),
        "elj": take(plan.e_lj),
        "esi": take(plan.e_si),
        "esj": take(plan.e_sj),
    }
    return plan, shard


def _no_edges():
    """Per-edge columns of no edges (an _AssemblyIndex for placement only)."""
    return (np.zeros(0, np.int64),) * 6


class RankShard(NamedTuple):
    """One rank's share of the fully-sharded GN loop: its edges, its
    blocks' _AssemblyIndex over those edges, where the edges' diagonal
    blocks and gradients go, and the replicated priors."""

    num_poses: int
    edges: torch.Tensor       # (Epd, 2) this rank's edges
    meas: torch.Tensor
    sq: torch.Tensor
    emask: torch.Tensor
    iloop: torch.Tensor
    ix: _AssemblyIndex        # this rank's blocks, over its edges
    diag_dest: torch.Tensor   # (2 Epd,) the slots of [Aii; Ajj] / [gi; gj] in [diagS (q); diagI]
    prior_idx: torch.Tensor
    prior_meas: torch.Tensor
    prior_sqrt_info: torch.Tensor
    prior_mask: torch.Tensor


def prepare_rank(graph, plan: SchurPlan, mesh: Mesh) -> RankShard:
    """This rank's RankShard, on the graph's device (host work once per
    topology)."""
    n_dev, r = mesh.size, mesh.rank
    plan_p, shard = _shard_numpy(graph, plan, n_dev)
    Epd = shard["edges"].shape[0] // n_dev
    loc = {k: v[r * Epd:(r + 1) * Epd] for k, v in shard.items()}
    S, q = plan_p.S, plan_p.q_pad
    Bpd = plan_p.B // n_dev
    cols = tuple(loc[k].astype(np.int64) for k in ("ecase", "ebl", "eli", "elj", "esi", "esj"))
    case, ebl, eli, elj, esi, esj = cols
    # Aii / gi at (b, li) for case 0, 1, else at si; Ajj / gj at (b, lj)
    # for case 0, 2, else at sj.
    i_int, j_int = (case == 0) | (case == 1), (case == 0) | (case == 2)
    dest_i = np.where(i_int, q + ebl * S + eli, esi)
    dest_j = np.where(j_int, q + ebl * S + elj, esj)
    dev = graph.device

    def t(k):
        return torch.from_numpy(loc[k]).to(dev)

    return RankShard(
        num_poses=plan_p.num_poses,
        edges=t("edges"), meas=t("meas"), sq=t("sq"), emask=t("emask"), iloop=t("iloop"),
        ix=_assembly_index(plan_p, dev, blocks=(r * Bpd, (r + 1) * Bpd), cols=cols),
        diag_dest=_rows(np.concatenate([dest_i, dest_j]), dev),
        prior_idx=graph.prior_idx.long(), prior_meas=graph.prior_meas,
        prior_sqrt_info=graph.prior_sqrt_info, prior_mask=graph.prior_mask,
    )


def gn_iteration(poses, sh: RankShard, mesh: Mesh, lam, huber_delta: float = 1.0,
                 use_huber: bool = False, mark=_no_mark):
    """One GN iteration of the fully-sharded loop on this rank (the JAX
    `gn_body`): linearize this rank's edges, assemble its interior systems
    and the separator partials, 3 all-reduces, retract. `mark(stage)` is
    called after each stage (a timer's hook)."""
    N = sh.num_poses
    ix = sh.ix
    B_loc, S = ix.imask.shape
    q = ix.smask.shape[0]
    dt, dev = poses.dtype, poses.device
    r, Ji, Jj = linearize_edges(poses, sh.edges, sh.meas, sh.sq, sh.emask, sh.iloop,
                                huber_delta=huber_delta, use_huber=use_huber)
    T = r.shape[-1]
    eyeT = torch.eye(T, dtype=dt, device=dev)
    Aii = torch.einsum("eki,ekj->eij", Ji, Ji)
    Aij = torch.einsum("eki,ekj->eij", Ji, Jj)
    Ajj = torch.einsum("eki,ekj->eij", Jj, Jj)
    gi = torch.einsum("eki,ek->ei", Ji, r)
    gj = torch.einsum("eki,ek->ei", Jj, r)

    # Diagonal blocks and gradients: interiors fully local (an edge with an
    # interior endpoint is owned by that endpoint's block's rank),
    # separators partial; off-diagonal blocks into [HII; HIS; HSS], of
    # which HSS is partial (SS edges are dealt round-robin).
    diag = _add_blocks(Aii.new_zeros((q + B_loc * S, T, T)), sh.diag_dest,
                       torch.cat([Aii, Ajj]))
    grad = _add_blocks(gi.new_zeros((q + B_loc * S, T)), sh.diag_dest, torch.cat([gi, gj]))
    HII, HIS, HSSo = _off_diag(ix, Aij)
    diagI, gI = diag[q:].view(B_loc, S, T, T), grad[q:].view(B_loc, S, T)
    mark("assemble_partials")
    # the separator partials, combined over the ranks in one all-reduce
    nd, ng = q * T * T, q * T
    buf = mesh.all_reduce(torch.cat([diag[:q].reshape(-1), grad[:q].reshape(-1),
                                     HSSo.reshape(-1)]))
    diagS = buf[:nd].view(q, T, T)
    gS = buf[nd:nd + ng].view(q, T)
    HSSo = buf[nd + ng:].view(q, q, T, T)
    mark("all_reduce_partials")

    # priors: replicated compute; interiors take theirs locally
    rp, Jp = linearize_priors(poses, sh.prior_idx, sh.prior_meas, sh.prior_sqrt_info,
                              sh.prior_mask)
    Dpri = _add_blocks(Jp.new_zeros((N, T, T)), sh.prior_idx,
                       torch.einsum("pki,pkj->pij", Jp, Jp))
    gpri = _add_blocks(Jp.new_zeros((N, T)), sh.prior_idx, torch.einsum("pki,pk->pi", Jp, rp))
    zero = torch.zeros((), dtype=dt, device=dev)
    diagI = diagI + torch.where(ix.imask[..., None, None], Dpri[ix.int_ids], zero)
    gI = gI + torch.where(ix.imask[..., None], gpri[ix.int_ids], zero)
    diagS = diagS + torch.where(ix.smask[:, None, None], Dpri[ix.sep_ids], zero)
    gS = gS + torch.where(ix.smask[:, None], gpri[ix.sep_ids], zero)

    # Marquardt damping on the TOTAL diagonals; pad slots identity
    dI = torch.diagonal(diagI, dim1=-2, dim2=-1)
    diagI = torch.where(ix.imask[..., None, None], diagI + lam * dI[..., None] * eyeT, eyeT)
    dS = torch.diagonal(diagS, dim1=-2, dim2=-1)
    diagS = torch.where(ix.smask[:, None, None], diagS + lam * dS[..., None] * eyeT, eyeT)

    # the diagonal blocks into the block matrices (an edge joins two poses,
    # so no edge's off-diagonal block lies there: a padded edge's zero one
    # is overwritten)
    bidx = torch.arange(B_loc, device=dev)[:, None]
    sidx = torch.arange(S, device=dev)[None, :]
    HII[bidx, sidx, sidx] = diagI
    qidx = torch.arange(q, device=dev)
    HSSo[qidx, qidx] += diagS
    A, Bm, C, bI, bS = _flatten(HII, HIS, HSSo, gI, gS)
    mark("assemble")

    xI, xS = _eliminate(A, Bm, bI, C, bS, all_reduce=mesh.all_reduce, mark=mark)
    dx = _gather_interiors(N, mesh, ix, xI, T)
    mark("all_reduce_dx")
    dx[ix.sep_dst] += xS.reshape(-1, T)[: ix.sep_dst.shape[0]]
    poses = _retract_all(poses, dx)
    mark("retract")
    return poses


def dist_schur_gn_solve(
    poses,
    graph,
    plan: SchurPlan,
    mesh: Mesh,
    iterations: int = 10,
    lam: float = 1e-6,
    axis: str = "dev",
    huber_delta: float = 1.0,
    use_huber: bool = False,
):
    """Gauss-Newton with the rank-sharded partitioned-Schur DIRECT solve as
    the inner linear solver (BASELINE config 5 end to end across ranks).

    Fully sharded per iteration: each rank linearizes ONLY the edges owned
    by its blocks (cross-separator edges round-robin), assembles its
    interior systems and separator partials, factorizes its blocks, and the
    separator system and the interior dx combine with all-reduces; no
    full-graph replicated linearize anywhere. `graph` is the whole graph on
    the mesh's device; every rank returns the same poses. `axis` is the JAX
    signature's mesh axis: a Mesh here has the one."""
    sh = prepare_rank(graph, plan, mesh)
    lam = torch.as_tensor(lam, dtype=poses.dtype, device=poses.device)
    for _ in range(iterations):
        poses = gn_iteration(poses, sh, mesh, lam, huber_delta, use_huber)
    return poses
