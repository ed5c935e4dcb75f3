"""Factor-sharded distributed Gauss-Newton / Levenberg-Marquardt on torch.distributed.

Port of graphslam_tpu/parallel/dist.py. The JAX code is one SPMD body under
`shard_map`; here the same body runs in every process of a process group,
one process per rank, and each `psum` of the JAX body is one
`torch.distributed.all_reduce` of one packed buffer:

  * Factors (edges) are sharded: `shard_graph` pads the edge list to a
    multiple of the world size and each rank keeps its own contiguous block.
    Linearization, the Hessian blocks and the gradient scatter run on each
    rank's block.
  * Poses are replicated; so are the priors, the damping, the preconditioner
    and every CG vector and scalar, computed identically on every rank.
  * Collectives: one all-reduce of [g; diag; err] per linearization, one of
    the chain blocks for the tridiagonal preconditioner, one per H@v in CG
    and one per candidate cost in LM.

A process group with one rank is an ordinary single-device solve; `make_mesh`
creates one over a local store when the process has none, so a caller on
one card needs no launcher. For several processes see parallel/multihost.py.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.factors.linearize import linearize_edges, linearize_priors


def default_backend(device: torch.device) -> str:
    """NCCL for CUDA tensors, gloo for CPU tensors."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


@dataclasses.dataclass(frozen=True)
class Mesh:
    """The ranks of a process group along one axis: the torch counterpart of
    a one-axis `jax.sharding.Mesh`. This process is rank `rank` of `size`
    and holds its tensors on `device`."""

    group: object
    rank: int
    size: int
    device: torch.device
    axis: str = "dev"

    @property
    def shape(self):
        return {self.axis: self.size}

    def all_reduce(self, t: torch.Tensor) -> torch.Tensor:
        """Sum `t` over the ranks, in place; returns it. A one-rank group
        runs the collective too, as a one-device psum does."""
        dist.all_reduce(t, group=self.group)
        return t


def make_mesh(num_devices: Optional[int] = None, axis: str = "dev", device=None) -> Mesh:
    """The mesh over this process group (all its ranks) on `device` (the
    card unless the caller asks for the CPU). Without a process group,
    first creates a one-rank one over a local store: NCCL on cuda, gloo on
    cpu. `num_devices`, where given, must be the group's size: a rank is a
    process here, and the processes of a job are fixed at its launch."""
    device = torch.device(device if device is not None else "cuda")
    if device.type == "cuda" and device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    if not dist.is_initialized():
        dist.init_process_group(default_backend(device), store=dist.HashStore(),
                                rank=0, world_size=1)
    size = dist.get_world_size()
    if num_devices is not None and num_devices != size:
        raise ValueError(f"num_devices={num_devices}, but the process group has {size} ranks: "
                         "start one process per rank (parallel/multihost.py)")
    return Mesh(group=dist.group.WORLD, rank=dist.get_rank(), size=size, device=device, axis=axis)


def shard_graph(graph: FactorGraph, mesh: Mesh) -> FactorGraph:
    """This rank's block of the graph's edges: the edge arrays padded to a
    multiple of the mesh size (padding masked off), then cut into equal
    contiguous blocks, one per rank. Priors stay whole (replicated). The
    block's chain_prefix is 0: the solvers here treat every edge alike."""
    n, E = mesh.size, graph.num_edges
    pad = (-E) % n
    per = (E + pad) // n
    lo = mesh.rank * per

    def block(x):
        x = x.to(mesh.device)
        if pad:
            x = torch.cat([x, torch.zeros((pad,) + tuple(x.shape[1:]), dtype=x.dtype,
                                          device=x.device)])
        return x[lo:lo + per].contiguous()

    return FactorGraph(
        edges=block(graph.edges),
        measurements=block(graph.measurements),
        sqrt_info=block(graph.sqrt_info),
        edge_mask=block(graph.edge_mask),  # padded entries get mask=False
        is_loop=block(graph.is_loop),
        prior_idx=graph.prior_idx.to(mesh.device),
        prior_meas=graph.prior_meas.to(mesh.device),
        prior_sqrt_info=graph.prior_sqrt_info.to(mesh.device),
        prior_mask=graph.prior_mask.to(mesh.device),
        chain_prefix=0,
    )


def _scatter(N: int, idx_vals) -> torch.Tensor:
    """Sum (index, values) pairs into N rows, in order (index_put_ with
    accumulate: a fixed order on CUDA too, no float atomics)."""
    out = None
    for idx, vals in idx_vals:
        if out is None:
            out = torch.zeros((N,) + tuple(vals.shape[1:]), dtype=vals.dtype, device=vals.device)
        out.index_put_((idx,), vals, accumulate=True)
    return out


def _local_normal_eq(poses, shard: FactorGraph, cfg: SolverConfig, mesh: Mesh):
    """This rank's linearization and ONE all-reduce of [g; diag; err]
    (dist.py:84-107). Returns (g, diag, this rank's Aij)."""
    N = poses.shape[0]
    r, Ji, Jj = linearize_edges(
        poses, shard.edges, shard.measurements, shard.sqrt_info, shard.edge_mask,
        shard.is_loop, huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops,
    )
    Aii = torch.einsum("eki,ekj->eij", Ji, Ji)
    Aij = torch.einsum("eki,ekj->eij", Ji, Jj)
    Ajj = torch.einsum("eki,ekj->eij", Jj, Jj)
    gi = torch.einsum("eki,ek->ei", Ji, r)
    gj = torch.einsum("eki,ek->ei", Jj, r)
    i_idx, j_idx = shard.edges[:, 0].long(), shard.edges[:, 1].long()
    T = r.shape[-1]
    g = _scatter(N, ((i_idx, gi), (j_idx, gj)))
    diag = _scatter(N, ((i_idx, Aii), (j_idx, Ajj)))
    err = torch.sum(r * r).reshape(1)
    buf = mesh.all_reduce(torch.cat([g.reshape(-1), diag.reshape(-1), err]))
    return buf[: N * T].reshape(N, T), buf[N * T: N * T * (T + 1)].reshape(N, T, T), Aij


_STOP_EVERY = 8


def _pcg(shard: FactorGraph, Aij, damped, precond, b, mesh: Mesh, max_iters: int, tol: float):
    """Replicated-x PCG with the sharded H@v (dist.py:117-151): each H@v is
    this rank's edge products plus one all-reduce. The JAX while_loop stops
    once |r|^2 <= tol^2 |b|^2; here an iteration past that point leaves x,
    r, p and rz as they are, which gives the same iterates, and one host
    read every `_STOP_EVERY` iterations ends the loop once that holds (on
    every rank at once: r is replicated)."""
    i_idx, j_idx = shard.edges[:, 0].long(), shard.edges[:, 1].long()
    N = b.shape[0]

    def hv(v):
        yi = torch.einsum("eij,ej->ei", Aij, v[j_idx])
        yj = torch.einsum("eji,ej->ei", Aij, v[i_idx])
        part = mesh.all_reduce(_scatter(N, ((i_idx, yi), (j_idx, yj))))
        return part + torch.einsum("nij,nj->ni", damped, v)

    tiny = torch.tensor(1e-30, dtype=b.dtype, device=b.device)
    x = torch.zeros_like(b)
    r = b  # b - H 0
    z = precond(r)
    p = z
    rz = torch.sum(r * z)
    thresh = tol * tol * torch.sum(b * b)
    for it in range(max_iters):
        active = torch.sum(r * r) > thresh
        if it % _STOP_EVERY == _STOP_EVERY - 1 and not bool(active):
            break
        Ap = hv(p)
        alpha = rz / torch.maximum(torch.sum(p * Ap), tiny)
        x_new = x + alpha * p
        r_new = r - alpha * Ap
        z = precond(r_new)
        rz_new = torch.sum(r_new * z)
        p_new = z + rz_new / torch.maximum(rz, tiny) * p
        x = torch.where(active, x_new, x)
        r = torch.where(active, r_new, r)
        p = torch.where(active, p_new, p)
        rz = torch.where(active, rz_new, rz)
    return x


def _chi2(x, shard: FactorGraph, cfg: SolverConfig, mesh: Mesh):
    """The cost of x: this rank's (IRLS-weighted) edge squares, one
    all-reduce, plus the replicated prior squares (dist.py:169-175)."""
    r, _, _ = linearize_edges(
        x, shard.edges, shard.measurements, shard.sqrt_info, shard.edge_mask, shard.is_loop,
        huber_delta=cfg.huber_delta, use_huber=cfg.use_huber_on_loops,
    )
    rp, _ = linearize_priors(x, shard.prior_idx, shard.prior_meas, shard.prior_sqrt_info,
                             shard.prior_mask)
    return mesh.all_reduce(torch.sum(r * r).reshape(1))[0] + torch.sum(rp * rp)


def _dist_solve(poses, shard: FactorGraph, mesh: Mesh, cfg: SolverConfig, iterations: int,
                lm: bool):
    """`iterations` GN or LM steps (dist.py:162-232); the LM accept/reject
    and lambda schedule are replicated on the device, with no host read."""
    from graphslam_tpu_torch.solver.lm import _retract_all
    from graphslam_tpu_torch.solver.normal_eq import _block_inv
    from graphslam_tpu_torch.solver.tridiag import chain_offdiag, cr_factor, cr_solve

    if poses.device != mesh.device or shard.device != mesh.device:
        raise ValueError(f"poses on {poses.device} and graph on {shard.device}, "
                         f"but the mesh holds its tensors on {mesh.device}")
    N, T = poses.shape[0], shard.tangent_dim
    dtype, dev = poses.dtype, poses.device
    eye = torch.eye(T, dtype=dtype, device=dev)
    pidx = shard.prior_idx.long()
    lam = torch.tensor(cfg.init_lambda if lm else 0.0, dtype=dtype, device=dev)
    err = _chi2(poses, shard, cfg, mesh) if lm else None
    for _ in range(iterations):
        g, diag, Aij = _local_normal_eq(poses, shard, cfg, mesh)
        rp, Jp = linearize_priors(poses, shard.prior_idx, shard.prior_meas,
                                  shard.prior_sqrt_info, shard.prior_mask)
        g = g.index_put((pidx,), torch.einsum("pki,pk->pi", Jp, rp), accumulate=True)
        diag = diag.index_put((pidx,), torch.einsum("pki,pkj->pij", Jp, Jp), accumulate=True)
        d = torch.diagonal(diag, dim1=-2, dim2=-1)
        damped = diag + lam * d[..., None] * eye
        if cfg.preconditioner == "tridiag":
            # the chain blocks assembled across ranks with one more
            # all-reduce; every rank then factors the same system
            U = mesh.all_reduce(chain_offdiag(shard.edges, Aij, N))
            fac = cr_factor(damped, U)

            def precond(r):
                return cr_solve(fac, r)
        else:
            Minv = _block_inv(damped)

            def precond(r):
                return torch.einsum("nij,nj->ni", Minv, r)

        dx = _pcg(shard, Aij, damped, precond, -g, mesh, cfg.cg_max_iterations, cfg.cg_tol)
        candidate = _retract_all(poses, dx)
        if not lm:
            poses = candidate
            continue
        new_err = _chi2(candidate, shard, cfg, mesh)
        accepted = new_err < err
        poses = torch.where(accepted, candidate, poses)
        lam = torch.where(accepted, torch.clamp(lam / cfg.lambda_factor, min=cfg.min_lambda),
                          torch.clamp(lam * cfg.lambda_factor, max=cfg.max_lambda))
        err = torch.where(accepted, new_err, err)
    return poses


def dist_gn_solve(
    poses: torch.Tensor,
    graph: FactorGraph,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 10,
    axis: str = "dev",
):
    """Distributed Gauss-Newton (fixed iterations) over a factor-sharded
    graph. `graph` should come from `shard_graph(graph, mesh)`; poses are
    replicated, on the mesh's device."""
    return _dist_solve(poses, graph, mesh, cfg, iterations, False)


def dist_lm_solve(
    poses: torch.Tensor,
    graph: FactorGraph,
    mesh: Mesh,
    cfg: SolverConfig = SolverConfig(),
    iterations: int = 30,
    axis: str = "dev",
):
    """Distributed LM with the accept/reject + lambda schedule run
    redundantly (replicated) on every rank."""
    return _dist_solve(poses, graph, mesh, cfg, iterations, True)
