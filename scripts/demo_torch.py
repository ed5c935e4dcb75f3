"""Closed-loop SLAM over the simulated world with the PyTorch/CUDA port
(graphslam_tpu_torch): the counterpart of scripts/demo.py, with the same
config, printed line and figures, and --device.

  python scripts/demo_torch.py [--beams 541] [--out chiprun_out/demo_torch] [--device cuda]

Writes OUT/demo_map.png and OUT/demo_traj.png (docs/demo_*.png are the JAX
package's figures).
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import argparse
import time

import numpy as np
import torch


def demo_config(beams: int):
    """scripts/demo.py's config: 256 keyframes, 1024 factors, 16 ICP
    iterations, mode pcg at cg 50, the beams padded to a multiple of 128."""
    from graphslam_tpu_torch.config import FrontendConfig, SLAMConfig, SolverConfig

    max_points = -(-beams // 128) * 128
    return SLAMConfig(
        max_keyframes=256, max_factors=1024,
        frontend=FrontendConfig(num_beams=beams, max_points=max_points, icp_iterations=16),
        solver=SolverConfig(mode="pcg", cg_max_iterations=50),
    )


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--beams", type=int, default=541)
    ap.add_argument("--out", default=os.path.join("chiprun_out", "demo_torch"))
    ap.add_argument("--device", default="cuda", help="torch device (default cuda)")
    args = ap.parse_args(argv)

    from graphslam_tpu_torch import metrics, viz
    from graphslam_tpu_torch.sim import simulate_trajectory
    from graphslam_tpu_torch.slam import run_slam
    from graphslam_tpu_torch.slam.pipeline import state_to_dataset

    cfg = demo_config(args.beams)
    sim = simulate_trajectory(cfg.frontend, step_len=0.3, seed=7, device=args.device)
    t0 = time.perf_counter()
    state, infos = run_slam(sim["scans"], sim["odom_deltas"], cfg, device=args.device)
    seconds = time.perf_counter() - t0

    n = int(state.num_kf)
    kf_steps = [t for t, i in enumerate(infos) if bool(i.is_keyframe)]
    gt = sim["gt_poses"][kf_steps]
    est = state.kf_poses[:n].cpu()
    ate = float(metrics.ate(est, torch.from_numpy(gt)))
    loops = sum(bool(i.added_loop) for i in infos)
    print(f"keyframes {n}, loop closures {loops}, ATE {ate:.3f} m")

    os.makedirs(args.out, exist_ok=True)
    map_png = os.path.join(args.out, "demo_map.png")
    traj_png = os.path.join(args.out, "demo_traj.png")
    viz.plot_map(state.kf_poses, state.kf_points, state.kf_masks, n, path=map_png)
    ds = state_to_dataset(state)
    # align ground truth into the estimate frame for the overlay (ATE above
    # is computed with the same rigid alignment)
    R, t = metrics.align_umeyama(torch.from_numpy(gt[:, :2]), est[:, :2])
    gt_aligned = np.asarray(gt).copy()
    gt_aligned[:, :2] = gt[:, :2] @ R.numpy().T + t.numpy()
    viz.plot_trajectory(
        est, gt=gt_aligned,
        edges=ds["edges"],
        is_loop=ds["is_loop"],
        # live pose_opti marginal covariances (Keyframe.msg contract) as
        # 1-sigma ellipses, the way rviz renders covariance markers
        covariances=ds["covariances"],
        ellipse_every=8,
        ellipse_sigma=1.0,
        path=traj_png,
        title=f"closed-loop SLAM ({n} keyframes, ATE {ate:.2f} m)",
    )
    print(f"wrote {map_png} {traj_png}")
    return {"keyframes": n, "loops": loops, "ate": ate, "scans": len(infos),
            "seconds": seconds, "figures": [map_png, traj_png]}


if __name__ == "__main__":
    main()
