"""Replayable odometry+scan logs (BASELINE config 3's dataset format):
port of graphslam_tpu/io/logs.py.

The reference could only be driven live by Stage + a human; this gives the
closed-loop frontend a durable, replayable format: one npz holding scans,
odometry deltas, optional ground truth, and the laser model parameters used
to record them. The keys and dtypes are the JAX package's, so a log
written by either package loads in the other.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from graphslam_tpu_torch.config import FrontendConfig


def save_log(
    path: str,
    scans: np.ndarray,
    odom_deltas: Optional[np.ndarray],
    gt_poses: Optional[np.ndarray],
    cfg: FrontendConfig,
) -> None:
    payload = {
        "scans": np.asarray(scans, np.float32),
        "num_beams": np.int64(cfg.num_beams),
        "fov_rad": np.float64(cfg.fov_rad),
        "max_range": np.float64(cfg.max_range),
    }
    if odom_deltas is not None:
        payload["odom_deltas"] = np.asarray(odom_deltas, np.float32)
    if gt_poses is not None:
        payload["gt_poses"] = np.asarray(gt_poses, np.float32)
    np.savez_compressed(path, **payload)


def load_log(path: str) -> Dict[str, np.ndarray]:
    z = np.load(path)
    out = {
        "scans": z["scans"],
        "num_beams": int(z["num_beams"]),
        "fov_rad": float(z["fov_rad"]),
        "max_range": float(z["max_range"]),
        "odom_deltas": z["odom_deltas"] if "odom_deltas" in z.files else None,
        "gt_poses": z["gt_poses"] if "gt_poses" in z.files else None,
    }
    return out
