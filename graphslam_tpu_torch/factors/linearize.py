"""Batched whitened residuals + Jacobians for prior/between factors.

Port of graphslam_tpu/factors/linearize.py, SE(2) (T = 3) and SE(3)
(T = 6). Residuals are Lie local coordinates r = Log(z^-1 · x_i^-1 · x_j)
(gtsam::BetweenFactor semantics); the Jacobians are the analytic
right-perturbation ones, with the Barfoot-Q inverse Jacobian in SE(3).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from graphslam_tpu_torch.factors.graph import FactorGraph
from graphslam_tpu_torch.geometry import se2, se3


def group_for(tangent_dim: int):
    """The geometry module of a tangent dimension: se2 (3) or se3 (6)."""
    if tangent_dim == 3:
        return se2
    if tangent_dim == 6:
        return se3
    raise ValueError(f"no pose group has tangent dimension {tangent_dim} (SE(2): 3, SE(3): 6)")


class Linearization(NamedTuple):
    """Whitened per-factor blocks at the current estimate.

    r      (E, T)      whitened between residuals
    Ji, Jj (E, T, T)   whitened Jacobians w.r.t. endpoint tangents
    rp     (P, T)      whitened prior residuals
    Jp     (P, T, T)   whitened prior Jacobians
    """

    r: torch.Tensor
    Ji: torch.Tensor
    Jj: torch.Tensor
    rp: torch.Tensor
    Jp: torch.Tensor


def residuals(poses: torch.Tensor, graph: FactorGraph) -> torch.Tensor:
    """Whitened between residuals (E, T), zeroed where masked."""
    g = group_for(graph.tangent_dim)
    xi = poses[graph.edges[:, 0].long()]
    xj = poses[graph.edges[:, 1].long()]
    r = g.local(graph.measurements, g.between(xi, xj))
    rw = torch.einsum("eab,eb->ea", graph.sqrt_info, r)
    return torch.where(graph.edge_mask[:, None], rw, torch.zeros_like(rw))


def _huber_weights(rw: torch.Tensor, is_loop: torch.Tensor, delta: float, enabled: bool):
    """IRLS sqrt-weights for a Huber kernel applied to loop edges only."""
    one = torch.ones(rw.shape[0], dtype=rw.dtype, device=rw.device)
    if not enabled:
        return one
    norm = torch.linalg.vector_norm(rw, dim=-1)
    w = torch.clamp(delta / torch.clamp(norm, min=1e-12), max=1.0)
    return torch.where(is_loop, torch.sqrt(w), one)


def chi2(
    poses: torch.Tensor,
    graph: FactorGraph,
    huber_delta: float = 1.0,
    use_huber: bool = False,
) -> torch.Tensor:
    """Total (optionally robustified) cost: sum of squared whitened residuals,
    with Huber rho on loop edges when enabled. This is GTSAM's `error()`."""
    g = group_for(graph.tangent_dim)
    rw = residuals(poses, graph)
    e = torch.sum(rw * rw, dim=-1)
    if use_huber:
        n = torch.sqrt(torch.clamp(e, min=1e-24))
        rho = torch.where(n <= huber_delta, e, 2.0 * huber_delta * n - huber_delta**2)
        e = torch.where(graph.is_loop, rho, e)
    e = torch.where(graph.edge_mask, e, torch.zeros_like(e))

    xp = poses[graph.prior_idx.long()]
    rp = g.local(graph.prior_meas, xp)
    rpw = torch.einsum("pab,pb->pa", graph.prior_sqrt_info, rp)
    ep = torch.sum(rpw * rpw, dim=-1)
    ep = torch.where(graph.prior_mask, ep, torch.zeros_like(ep))
    return torch.sum(e) + torch.sum(ep)


def linearize_edges(
    poses: torch.Tensor,
    edges: torch.Tensor,
    measurements: torch.Tensor,
    sqrt_info: torch.Tensor,
    edge_mask: torch.Tensor,
    is_loop: torch.Tensor,
    huber_delta: float = 1.0,
    use_huber: bool = False,
):
    """Whitened (r, Ji, Jj) for an arbitrary slice of between-edges.

    Analytic in SE(2) and SE(3): r = Log(z^-1 h) with h = x_i^-1 x_j;
      dr/d(delta_j) =  Jr^{-1}(r)
      dr/d(delta_i) = -Jr^{-1}(r) Ad(h^-1)
    """
    g = group_for(sqrt_info.shape[-1])
    xi = poses[edges[:, 0].long()]
    xj = poses[edges[:, 1].long()]
    h = g.between(xi, xj)
    r = g.log(g.between(measurements, h))
    Jr_inv = g.right_jacobian_inv(r)
    Ad_hinv = g.adjoint(g.inverse(h))
    Jj = Jr_inv
    Ji = -torch.einsum("eab,ebc->eac", Jr_inv, Ad_hinv)

    rw = torch.einsum("eab,eb->ea", sqrt_info, r)
    Jiw = torch.einsum("eab,ebc->eac", sqrt_info, Ji)
    Jjw = torch.einsum("eab,ebc->eac", sqrt_info, Jj)

    sw = _huber_weights(rw, is_loop, huber_delta, use_huber)
    m = torch.where(edge_mask, sw, torch.zeros_like(sw))[:, None]
    return rw * m, Jiw * m[..., None], Jjw * m[..., None]


def linearize_priors(
    poses: torch.Tensor,
    prior_idx: torch.Tensor,
    prior_meas: torch.Tensor,
    prior_sqrt_info: torch.Tensor,
    prior_mask: torch.Tensor,
):
    """Whitened (rp, Jp) for the prior factors."""
    g = group_for(prior_sqrt_info.shape[-1])
    xp = poses[prior_idx.long()]
    rp = g.log(g.between(prior_meas, xp))
    Jp = g.right_jacobian_inv(rp)
    rpw = torch.einsum("pab,pb->pa", prior_sqrt_info, rp)
    Jpw = torch.einsum("pab,pbc->pac", prior_sqrt_info, Jp)
    pm = prior_mask[:, None].to(poses.dtype)
    return rpw * pm, Jpw * pm[..., None]


def linearize(
    poses: torch.Tensor,
    graph: FactorGraph,
    huber_delta: float = 1.0,
    use_huber: bool = False,
) -> Linearization:
    """Whitened residuals and Jacobians at `poses` for every factor at once."""
    rw, Jiw, Jjw = linearize_edges(
        poses,
        graph.edges,
        graph.measurements,
        graph.sqrt_info,
        graph.edge_mask,
        graph.is_loop,
        huber_delta=huber_delta,
        use_huber=use_huber,
    )
    rpw, Jpw = linearize_priors(
        poses,
        graph.prior_idx,
        graph.prior_meas,
        graph.prior_sqrt_info,
        graph.prior_mask,
    )
    return Linearization(r=rw, Ji=Jiw, Jj=Jjw, rp=rpw, Jp=Jpw)
