#!/usr/bin/env python3
"""The JAX package's closed-loop replay at bench_all.py's frontend config.

Usage:  JAX_PLATFORMS=cpu python scripts/replay_gate_jax.py [--scans N]

Runs graphslam_tpu.slam.pipeline.make_slam_replay with the config of
scripts/bench_all.py::bench_frontend (1024-keyframe capacity, 4 warm GN
iterations at cg 12 in mode gn_fused, 1081 beams padded to 1152 points)
over the first min(300, T) scans of simulate_trajectory(step_len=0.25,
seed=1), and prints one JSON line: keyframes, loop closures, the keyframe
ATE against ground truth at the keyframe scans and the dead-reckoned ATE at
the same scans. These are the reference numbers that chip_smoke.py's
replay gate for the PyTorch port is taken from.
"""

import argparse
import json
import time

import jax.numpy as jnp
import numpy as np

from graphslam_tpu import metrics
from graphslam_tpu.config import SLAMConfig, SolverConfig
from graphslam_tpu.geometry import se2
from graphslam_tpu.sim import simulate_trajectory
from graphslam_tpu.slam import init_state
from graphslam_tpu.slam.pipeline import make_slam_replay


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scans", type=int, default=300)
    args = ap.parse_args()

    cfg = SLAMConfig(
        max_keyframes=1024,
        max_factors=1024,
        solve_iterations=4,
        solver=SolverConfig(mode="gn_fused", cg_max_iterations=12),
    )
    sim = simulate_trajectory(cfg.frontend, step_len=0.25, seed=1)
    n = min(args.scans, len(sim["scans"]))
    odom = np.concatenate([np.zeros((1, 3), np.float32), sim["odom_deltas"][: n - 1]])
    t0 = time.perf_counter()
    state, infos = make_slam_replay(cfg, n)(
        init_state(cfg), jnp.asarray(sim["scans"][:n]), jnp.asarray(odom)
    )
    nkf = int(state.num_kf)
    seconds = time.perf_counter() - t0

    steps = np.flatnonzero(np.asarray(infos.is_keyframe))
    gt = sim["gt_poses"][:n]
    ate = float(metrics.ate(state.kf_poses[:nkf], jnp.asarray(gt[steps])))
    dead = [gt[0]]
    for d in sim["odom_deltas"][: n - 1]:
        dead.append(np.asarray(se2.compose(jnp.asarray(dead[-1]), jnp.asarray(d))))
    ate_dead = float(metrics.ate(jnp.asarray(np.asarray(dead)[steps]), jnp.asarray(gt[steps])))
    print(json.dumps({
        "scans": n,
        "keyframes": nkf,
        "loops": int(state.num_loops),
        "ate": ate,
        "ate_dead_reckoned": ate_dead,
        "seconds_with_compile": seconds,
    }))


if __name__ == "__main__":
    main()
