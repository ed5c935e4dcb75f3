"""The port's observability helpers (utils.Stopwatch, utils.Counters), its
dry-run entry points (dryrun.py) and its scripts (scripts/solve_torch.py,
scripts/teleop_torch.py), on the CPU.

Tolerances: the CLI's written graph equals, byte for byte, the same
solve's graph written in process with the same SolverConfig (and so its
SE(2) poses equal bit for bit); everything else is exact (counts, shapes,
printed lines).
"""

import importlib.util
import logging
import os
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

from graphslam_tpu_torch import dryrun
from graphslam_tpu_torch.utils import Counters, Stopwatch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _script(name):
    spec = importlib.util.spec_from_file_location(name, os.path.join(REPO, "scripts",
                                                                     f"{name}.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_stopwatch_accumulates(caplog):
    sw = Stopwatch()
    for _ in range(3):
        with sw.time("stage", sync_tree=torch.ones(2)):
            time.sleep(0.01)
    s = sw.summary()["stage"]
    assert s["count"] == 3
    assert s["total_s"] >= 0.03
    assert s["mean_ms"] >= 10.0
    with caplog.at_level(logging.INFO, logger="graphslam_tpu_torch"):
        sw.log_summary()
    assert [r.name for r in caplog.records] == ["graphslam_tpu_torch"]
    assert "3 calls" in caplog.records[0].getMessage()


def test_counters():
    c = Counters()
    c.bump("keyframes")
    c.bump("keyframes")
    c.bump("loops", 5)
    assert c.as_dict() == {"keyframes": 2, "loops": 5}


def test_entry_gn_step_on_cpu():
    from graphslam_tpu_torch.factors import chi2

    fn, (poses, graph) = dryrun.entry(device="cpu")
    assert poses.device.type == "cpu" and poses.shape == (512, 3)
    out = fn(poses, graph)
    assert out.shape == poses.shape and torch.isfinite(out).all()
    assert float(chi2(out, graph)) < 0.5 * float(chi2(poses, graph))


def test_dryrun_multichip_two_gloo_ranks():
    report = dryrun.dryrun_multichip(2, device="cpu")
    assert report["world"] == 2 and report["backend"] == "gloo"
    assert report["shapes"] == {
        "dist_lm": [64, 3], "dist_schur_gn": [64, 3], "dist_fused_gn": [64, 3],
        "dist_fused_lm": [64, 3], "dist_fused_gn_cg_kernel": [64, 3],
        "dist_fused6_gn": [32, 12]}
    assert set(report["launches"].values()) == {0}  # CPU tensors: the plain versions


def test_dryrun_multichip_never_drops_to_the_cpu():
    if torch.cuda.is_available():
        pytest.skip("the card is there: nothing to refuse")
    with pytest.raises(RuntimeError, match="one card a rank"):
        dryrun.dryrun_multichip(1)


def test_solve_cli_matches_in_process_lm_solve(tmp_path):
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets, load_g2o, save_g2o
    from graphslam_tpu_torch.solver import lm_solve

    src = str(tmp_path / "m120.g2o")
    save_g2o(src, datasets.manhattan(n_poses=120, seed=3))
    out, plot = str(tmp_path / "out.g2o"), str(tmp_path / "out.png")
    argv = [src, "--mode", "gn_fused", "--iters", "4", "--cg-iters", "10", "--huber",
            "--device", "cpu", "--out", out, "--plot", plot]
    res = subprocess.run([sys.executable, os.path.join(REPO, "scripts", "solve_torch.py"),
                          *argv], capture_output=True, text=True, timeout=300, cwd=str(tmp_path))
    assert res.returncode == 0, res.stderr
    lines = res.stderr.strip().splitlines()
    assert lines[0] == "poses: 120  edges: 123"
    assert lines[1].startswith("chi2: ") and "in 4 LM iterations" in lines[1]
    assert lines[2:] == [f"wrote {out}", f"wrote {plot}"]
    assert os.path.getsize(plot) > 1000

    solve = _script("solve_torch")
    data = datasets.load(src)
    graph = from_dataset(data, device="cpu")
    mine = lm_solve(torch.from_numpy(data["poses"]), graph, solve.solver_config(
        solve.parse_args(argv)))
    U = graph.sqrt_info
    ref = str(tmp_path / "ref.g2o")
    save_g2o(ref, {"dim": 2, "poses": mine.poses.numpy(), "edges": graph.edges.numpy(),
                   "measurements": graph.measurements.numpy(),
                   "information": torch.einsum("eba,ebc->eac", U, U).numpy()})
    assert open(out).read() == open(ref).read()
    assert np.array_equal(load_g2o(out)["poses"], mine.poses.numpy())


def test_teleop_drive_scripted_keys(tmp_path, capsys):
    from graphslam_tpu_torch.config import FrontendConfig, SLAMConfig

    teleop = _script("teleop_torch")
    cfg = SLAMConfig(max_keyframes=16, max_factors=32,
                     frontend=FrontendConfig(num_beams=181, max_points=256))
    sess, state, pose = teleop.session(cfg, device="cpu")
    out = str(tmp_path / "map.png")
    d = teleop.drive("q" + "i" * 3 + "xu" * 3 + "\x03" + "i", state, pose, sess, out)
    printed = capsys.readouterr().out.splitlines()
    assert d.stopped and d.tick == 6
    assert printed[0] == "speed 0.55 turn 1.10"
    assert [l.split()[0] for l in printed[1:]] == [f"t={t}" for t in range(1, 7)]
    assert printed[1].endswith("[keyframe]") and int(d.state.num_kf) >= 1
    assert os.path.getsize(out) > 1000
    assert abs(float(d.speed) - 0.55) < 1e-12
    assert torch.isfinite(d.pose).all() and float(d.pose[0]) > teleop.START_POSE[0]
