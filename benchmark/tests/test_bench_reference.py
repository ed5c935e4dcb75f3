"""The plain reference solves small maps to their ground truth."""

import numpy as np
import pytest
import torch

from benchmark import specs
from benchmark.reference import solve as reference
from benchmark.tests._small import SMALL

LM = {"method": "lm", "iterations": 20, "huber": 1.0, "solve": "dense", "lam0": 1e-5,
      "lam_factor": 10.0, "lam_min": 1e-10, "lam_max": 1e7}


def _map(name, seed=4):
    cfg = {**specs.data("configs", name), **SMALL[name]}
    return specs.module("generators", cfg["generator"]).make(cfg, seed)


@pytest.mark.parametrize("name", ["m3500", "sphere2500"])
@pytest.mark.parametrize("ref", [
    {"method": "gn", "iterations": 8, "huber": None, "solve": "dense", "lam": 0.0},
    {"method": "gn", "iterations": 8, "huber": None, "solve": "schur", "blocks": 8, "lam": 1e-6},
    LM,
])
def test_the_reference_solves_to_the_ground_truth(name, ref):
    data = _map(name)
    dim = data["poses"].shape[-1]
    out = reference.solve(data, ref, "cpu")
    before = reference.ate(data["poses"].astype(np.float64), data["gt"], dim)
    after = reference.ate(out["poses"], data["gt"], dim)
    # odometry drifts by metres; the solution sits within the measurements'
    # noise of the truth, at a cost near the residuals' degrees of freedom
    assert before > 1.0 and after < 0.5
    T = 3 if dim == 3 else 6
    dof = (len(data["edges"]) - data["poses"].shape[0] + 1) * T
    assert 0.5 * dof < out["cost"] < 2.0 * dof
    assert out["cost"] == pytest.approx(
        reference.cost_at(data, out["poses"], ref.get("huber"), "cpu"), rel=1e-12)


@pytest.mark.parametrize("name", ["m3500", "sphere2500"])
def test_the_schur_step_is_the_dense_step(name):
    data = _map(name)
    prob = reference.Problem(data, "cpu", reference.Precision("float64"))
    H, g = prob.normal_equations(prob.x0, None)
    plan = reference.schur_plan(data["edges"], prob.N, 8)
    assert len(plan[1]) > 0
    a, b = reference.dense_step(H, g, prob), reference.schur_step(H, g, prob, plan)
    assert torch.allclose(a, b, rtol=1e-9, atol=1e-9)


def test_the_jacobians_are_the_residuals_derivatives():
    """Forward differences of the residual agree with the Jacobian blocks."""
    data = _map("sphere2500")
    prob = reference.Problem(data, "cpu", reference.Precision("float64"))
    x = prob.x0
    H, g = prob.normal_equations(x, None)
    r0, _ = prob.residuals(x)
    d = torch.zeros(prob.N, prob.T, dtype=torch.float64)
    d[5, 4] = 1e-7
    r1, _ = prob.residuals(prob.G.compose(x, prob.G.exp(d)))
    # the gradient's entry is J^T r; check it through the cost's change
    dc = ((r1 * r1).sum() - (r0 * r0).sum()) / 1e-7
    assert float(2 * g.reshape(prob.N, prob.T)[5, 4]) == pytest.approx(float(dc), rel=1e-4)


@pytest.mark.parametrize("name", ["m3500", "sphere2500"])
def test_the_aligned_gaps_see_through_a_rigid_motion_only(name):
    """A map moved as a whole reads 0 in the aligned gaps; one pose turned
    in place reads its angle in `aligned_rot_gap_rad`, 0 in `aligned_gap_m`."""
    from benchmark import judge
    from benchmark.reference.lie import group

    gt = torch.from_numpy(_map(name)["gt"].astype(np.float64))
    G = group(gt.shape[-1])
    move = G.exp(torch.tensor([0.4, -1.0, 0.7] if G.tangent == 3 else
                              [0.4, -1.0, 2.0, 0.3, -0.2, 0.7], dtype=torch.float64))
    moved = G.compose(move.expand(gt.shape), gt)
    turn = torch.zeros(G.tangent, dtype=torch.float64)
    turn[-1] = 0.05
    turned = moved.clone()
    turned[5] = G.compose(moved[5], G.exp(turn))
    ref = {"poses": gt.numpy(), "cost": 1.0}
    a = judge.numbers({"poses": moved.numpy()}, ref, lambda x: 1.0)
    b = judge.numbers({"poses": turned.numpy()}, ref, lambda x: 1.0)
    assert a["aligned_gap_m"] < 1e-9 and a["aligned_rot_gap_rad"] < 1e-9 and a["rot_gap_rad"] > 0.5
    assert b["aligned_gap_m"] < 1e-9 and b["aligned_rot_gap_rad"] == pytest.approx(0.05)
