"""Chordal initialization for SE(2) and SE(3) pose graphs: port of graphslam_tpu/solver/init.py.

Odometry-integrated initial guesses accumulate unbounded heading drift; when
it exceeds ~90 deg, Gauss-Newton basins stop containing the global optimum.
The standard cure (Carlone et al.) is a two-stage LINEAR bootstrap:

  1. Rotation averaging in chordal coordinates: each node's heading is a
     unit vector x_i = (cos t_i, sin t_i); an edge with measured rotation
     t_z gives the linear residual  G(t_z) x_i - x_j  (G = 2x2 rotation).
     One anchored linear least-squares over all headings.
  2. Translation recovery: with headings fixed, t_j ~ t_i + R(t_i) t_z is
     linear in positions, a second anchored least-squares.

Both systems reuse the solver's block machinery (BlockSystem + PCG with the
chain preconditioner) at T=2, and at T=3 for the rows of SE(3) rotations.
"""

from __future__ import annotations

import torch

from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.geometry import se3, so2, so3
from graphslam_tpu_torch.solver.normal_eq import BlockSystem, pcg_solve


def _linear_system(edges, G_blocks, rhs_e, num_poses, anchor_val, anchor_w, w) -> BlockSystem:
    """Normal equations for  sum_e ||G_e x_i - x_j - rhs_e||^2  with an
    anchor on node 0, phrased as a BlockSystem for pcg_solve.

    For edge e: Ji = G_e, Jj = -I, r0_e = -rhs_e (residual at x=0); solving
    the normal equations from x=0 gives the global optimum of the linear
    problem directly. Works for any block size T."""
    E, T = edges.shape[0], G_blocks.shape[-1]
    dtype, dev = G_blocks.dtype, G_blocks.device
    eye = torch.eye(T, dtype=dtype, device=dev)
    Ji = G_blocks * w[:, None, None]
    Jj = -eye.expand(E, T, T) * w[:, None, None]
    Aii = torch.einsum("eki,ekj->eij", Ji, Ji)
    Aij = torch.einsum("eki,ekj->eij", Ji, Jj)
    Ajj = torch.einsum("eki,ekj->eij", Jj, Jj)
    gi = torch.einsum("eki,ek->ei", Ji, -rhs_e)
    gj = torch.einsum("eki,ek->ei", Jj, -rhs_e)

    i_idx, j_idx = edges[:, 0].long(), edges[:, 1].long()
    g = torch.zeros((num_poses, T), dtype=dtype, device=dev)
    g.index_put_((i_idx,), gi, accumulate=True).index_put_((j_idx,), gj, accumulate=True)
    diag = torch.zeros((num_poses, T, T), dtype=dtype, device=dev)
    diag.index_put_((i_idx,), Aii, accumulate=True).index_put_((j_idx,), Ajj, accumulate=True)
    diag[0] += anchor_w * eye
    g[0] -= anchor_w * anchor_val
    return BlockSystem(Aii=Aii, Aij=Aij, Ajj=Ajj, diag=diag, g=g, edges=edges)


def chordal_init_se2(graph: FactorGraph, num_poses: int, cg_iters: int = 150) -> torch.Tensor:
    """Initial SE(2) poses (N, 3) from the two-stage linear bootstrap."""
    z = graph.measurements
    dtype, dev = z.dtype, z.device
    w = graph.edge_mask.to(dtype)
    edges = graph.edges
    zero = torch.zeros((), dtype=dtype, device=dev)

    def solve(sys):
        return pcg_solve(sys, zero, max_iters=cg_iters, tol=1e-8, lm_diag_scaling=False,
                         preconditioner="tridiag", chain_prefix=graph.chain_prefix)

    # stage 1: headings
    rhs = torch.zeros((edges.shape[0], 2), dtype=dtype, device=dev)
    anchor = torch.tensor([1.0, 0.0], dtype=dtype, device=dev)
    x = solve(_linear_system(edges, so2.rotmat(z[:, 2]), rhs, num_poses, anchor, 100.0, w))
    theta = torch.atan2(x[:, 1], x[:, 0])

    # stage 2: positions. t_j = t_i + R(theta_i) t_z, i.e. the residual
    # I t_i - t_j - (-R(theta_i) t_z).
    eye2 = torch.eye(2, dtype=dtype, device=dev).expand(edges.shape[0], 2, 2)
    rhs_t = -so2.rotate(theta[edges[:, 0].long()], z[:, :2]) * w[:, None]
    t = solve(_linear_system(edges, eye2, rhs_t, num_poses, torch.zeros_like(anchor), 100.0, w))
    return torch.cat([t, theta[:, None]], dim=-1)


def chordal_init_se3(graph: FactorGraph, num_poses: int, cg_iters: int = 150) -> torch.Tensor:
    """Initial SE(3) poses (N, 12) from the chordal bootstrap.

    Rotations: R_j ~ R_i Rz means each ROW of R satisfies row_j = Rz^T row_i,
    three independent T=3 linear problems (one per anchor row of R_0 = I),
    then the SVD projection onto SO(3). Translations: t_j ~ t_i + R_i t_z
    is linear given the rotations."""
    z = graph.measurements
    dtype, dev = z.dtype, z.device
    w = graph.edge_mask.to(dtype)
    edges = graph.edges
    zero = torch.zeros((), dtype=dtype, device=dev)
    Rz, tz = se3.rot(z), se3.trans(z)

    def solve(sys):
        return pcg_solve(sys, zero, max_iters=cg_iters, tol=1e-8, lm_diag_scaling=False,
                         preconditioner="tridiag", chain_prefix=graph.chain_prefix)

    # rotations: one T=3 system per row of R
    G = Rz.transpose(-1, -2)  # row_j = Rz^T row_i
    rhs0 = torch.zeros((edges.shape[0], 3), dtype=dtype, device=dev)
    anchors = torch.eye(3, dtype=dtype, device=dev)  # rows of R_0 = I
    rows = torch.stack([solve(_linear_system(edges, G, rhs0, num_poses, a, 100.0, w))
                        for a in anchors])          # (3, N, 3)
    R = so3.project(rows.permute(1, 0, 2))          # (N, 3, 3) rows stacked

    # translations
    eye3 = torch.eye(3, dtype=dtype, device=dev).expand(edges.shape[0], 3, 3)
    Ri = R[edges[:, 0].long()]
    rhs_t = -(Ri @ tz[..., None])[..., 0] * w[:, None]
    t = solve(_linear_system(edges, eye3, rhs_t, num_poses, torch.zeros(3, dtype=dtype, device=dev),
                             100.0, w))
    return se3.make(R, t)
