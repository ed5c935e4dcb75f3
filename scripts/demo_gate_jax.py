#!/usr/bin/env python3
"""The JAX package's closed-loop demo (scripts/demo.py's config) on the CPU.

Usage:  JAX_PLATFORMS=cpu python scripts/demo_gate_jax.py [--beams 541]

Runs graphslam_tpu.slam.run_slam with scripts/demo.py's config (256
keyframes, 1024 factors, 541 beams padded to 640 points, 16 ICP
iterations, mode pcg at cg 50) over simulate_trajectory(step_len=0.3,
seed=7), and prints one JSON line: scans, keyframes, loop closures and the
keyframe ATE against ground truth at the keyframe scans. These are the
reference numbers of chip_smoke.py's gate on scripts/demo_torch.py.
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import json

import numpy as np


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", type=int, default=541)
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from graphslam_tpu import metrics
    from graphslam_tpu.config import FrontendConfig, SLAMConfig, SolverConfig
    from graphslam_tpu.sim import simulate_trajectory
    from graphslam_tpu.slam import run_slam

    max_points = -(-args.beams // 128) * 128
    cfg = SLAMConfig(
        max_keyframes=256, max_factors=1024,
        frontend=FrontendConfig(
            num_beams=args.beams, max_points=max_points, icp_iterations=16
        ),
        solver=SolverConfig(mode="pcg", cg_max_iterations=50),
    )
    sim = simulate_trajectory(cfg.frontend, step_len=0.3, seed=7)
    state, infos = run_slam(sim["scans"], sim["odom_deltas"], cfg)

    n = int(state.num_kf)
    kf_steps = [t for t, i in enumerate(infos) if bool(i.is_keyframe)]
    gt = sim["gt_poses"][kf_steps]
    ate = float(
        metrics.ate(jnp.asarray(np.asarray(state.kf_poses[:n])), jnp.asarray(gt))
    )
    loops = sum(bool(i.added_loop) for i in infos)
    print(json.dumps({"scans": len(infos), "keyframes": n, "loops": loops, "ate": ate,
                      "jax": jax.__version__}))


if __name__ == "__main__":
    main()
