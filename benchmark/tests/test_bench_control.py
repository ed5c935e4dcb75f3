"""The comparison fails the control and the faults a cell can have.

Run here on the CPU at a small size: the control (the reference computed
in the mix's lower precision, put in the program's place), then the
harness with the timed path broken underneath: a solve that returns its
start unchanged, a solve that leaves out half of the loop closures, an
answer altered where it is produced (a position, or one pose's orientation
with its position kept), and in the LM cell faults inside the solve that
leave the reported error true to the poses."""

import math

import numpy as np
import pytest
import torch

from benchmark import calibrate, judge, run, specs
from benchmark.tests._small import CELLS, small


@pytest.mark.parametrize("seed", [21, 22, 23])
@pytest.mark.parametrize("cell", CELLS)
def test_the_control_is_not_correct(cell, seed):
    nums = calibrate.control_numbers(cell, seed, "cpu", overrides=small(cell))
    assert not judge.within(nums, specs.data("cells", cell)["limits"])


def _entry_fn(cell):
    mix = specs.data("traffic", specs.cell(specs.benchmark(), cell)["traffic"])
    return {"lm_solve": ("graphslam_tpu_torch.solver.lm", "lm_solve"),
            "gn_solve": ("graphslam_tpu_torch.solver.lm", "gn_solve"),
            "dist_schur": ("graphslam_tpu_torch.parallel.dist_schur", "dist_schur_gn_solve")}[mix["entry"]]


def _unchanged(fn):
    def f(p0, graph, *a, **k):
        out = fn(p0, graph, *a, **k)
        return out._replace(poses=p0) if hasattr(out, "_replace") else p0
    return f


def _half_the_loops(fn):
    def f(p0, graph, *a, **k):
        loops = torch.nonzero(graph.is_loop).flatten()
        mask = graph.edge_mask.clone()
        mask[loops[::2]] = False
        return fn(p0, graph.replace(edge_mask=mask), *a, **k)
    return f


def _altered(fn):
    def f(p0, graph, *a, **k):
        out = fn(p0, graph, *a, **k)
        poses = out.poses if hasattr(out, "_replace") else out
        poses = poses.clone()
        poses[len(poses) // 2, -1] += 1.0   # SE(2): 1 rad of heading; SE(3): 1 m up
        return out._replace(poses=poses) if hasattr(out, "_replace") else poses
    return f


def _turned(fn):
    def f(p0, graph, *a, **k):
        out = fn(p0, graph, *a, **k)
        poses = out.poses if hasattr(out, "_replace") else out
        poses = poses.clone()
        k = len(poses) // 2
        if poses.shape[-1] == 3:   # SE(2): the heading
            poses[k, 2] += 0.3
        else:                      # SE(3): R turned about its own z axis
            c, s = math.cos(0.3), math.sin(0.3)
            Rz = torch.tensor([[c, -s, 0.0], [s, c, 0.0], [0.0, 0.0, 1.0]], dtype=poses.dtype)
            poses[k, :9] = (poses[k, :9].reshape(3, 3) @ Rz.to(poses.device)).reshape(9)
        return out._replace(poses=poses) if hasattr(out, "_replace") else poses
    return f


@pytest.mark.parametrize("fault", [_unchanged, _half_the_loops, _altered, _turned])
@pytest.mark.parametrize("cell", CELLS)
def test_a_broken_path_is_not_correct(cell, fault, monkeypatch):
    import importlib

    mod_name, fn_name = _entry_fn(cell)
    mod = importlib.import_module(mod_name)
    monkeypatch.setattr(mod, fn_name, fault(getattr(mod, fn_name)))
    out = run.run_cell(cell, 31, 0.2, False, "cpu", overrides=small(cell))
    assert out["correct"] is False and out["failed"] == out["attempted"]


def test_an_altered_error_is_not_correct(monkeypatch):
    """The LM cell also compares the cost that the answer reports."""
    from graphslam_tpu_torch.solver import lm

    fn = lm.lm_solve

    def f(*a, **k):
        out = fn(*a, **k)
        return out._replace(error=out.error * 1.05)

    monkeypatch.setattr(lm, "lm_solve", f)
    out = run.run_cell("m3500.lm-huber", 32, 0.2, False, "cpu", overrides=small("m3500.lm-huber"))
    assert out["correct"] is False
    assert np.isfinite(out["checks"]["error_self_gap"]["value"])


def _step_scaled(stages):
    """Every LM step a hundredth of the solved one: each is still accepted."""
    from graphslam_tpu_torch.ops import gn_kernel

    cg = gn_kernel.cg_reference
    return "cg_reference", lambda *a, **k: 0.01 * cg(*a, **k)


def _huber_weight_wrong(stages):
    """The step's system weighs the loops with Huber at a tenth of the
    configured width; the cost that accepts a step and is reported is right."""
    return "SE2_STAGES", stages._replace(
        system=lambda poses, pk, delta, lam: stages.system(poses, pk, 0.1 * delta, lam))


@pytest.mark.parametrize("fault", [_step_scaled, _huber_weight_wrong])
def test_a_fault_inside_the_lm_solve_is_not_correct(fault, monkeypatch):
    """Faults planted in the fused LM solve's CPU path (the kernel's plain
    torch twin) that keep the reported error true to the answer's poses:
    the gap to the reference's cost catches them."""
    from graphslam_tpu_torch.ops import gn_kernel

    monkeypatch.setattr(gn_kernel, *fault(gn_kernel.SE2_STAGES))
    out = run.run_cell("m3500.lm-huber", 33, 0.2, False, "cpu", overrides=small("m3500.lm-huber"))
    checks = out["checks"]
    assert out["correct"] is False
    assert checks["cost_gap"]["value"] > checks["cost_gap"]["limit"]
    assert checks["error_self_gap"]["value"] <= checks["error_self_gap"]["limit"]
