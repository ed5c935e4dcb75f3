"""Olson-style Manhattan-world SE(2) pose graph (the M3500 construction).

A copy of the construction in graphslam_tpu_torch/io/datasets.py::manhattan,
kept here so that the yardstick does not move with the program. One change:
the ground-truth walk and the choice of loop closures come from
`structure_seed` (a number of the configuration), and only the noise of the
measurements comes from the run's seed. So every seed poses the same graph
(M3500 is one published graph) with another draw of the noise, and the
work of a request is the same on every seed.
"""

from __future__ import annotations

from collections import defaultdict

import numpy as np


def _between(a, b):
    dx = b[..., 0] - a[..., 0]
    dy = b[..., 1] - a[..., 1]
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    out = np.empty_like(a)
    out[..., 0] = c * dx + s * dy
    out[..., 1] = -s * dx + c * dy
    out[..., 2] = np.arctan2(np.sin(b[..., 2] - a[..., 2]), np.cos(b[..., 2] - a[..., 2]))
    return out


def _compose(a, b):
    c, s = np.cos(a[..., 2]), np.sin(a[..., 2])
    out = np.empty_like(a)
    out[..., 0] = a[..., 0] + c * b[..., 0] - s * b[..., 1]
    out[..., 1] = a[..., 1] + s * b[..., 0] + c * b[..., 1]
    th = a[..., 2] + b[..., 2]
    out[..., 2] = np.arctan2(np.sin(th), np.cos(th))
    return out


def make(p: dict, seed: int) -> dict:
    """The map of `seed`: {"dim", "poses" (the odometry guess), "edges",
    "measurements", "information", "is_loop", "gt"}, numpy arrays."""
    n = int(p["n_poses"])
    step, ts, rs = float(p["step"]), float(p["trans_sigma"]), float(p["rot_sigma"])
    walk = np.random.default_rng(int(p["structure_seed"]))
    noise = np.random.default_rng(seed % 2**64)
    extent = p.get("extent") or max(5, int(0.55 * np.sqrt(n)))

    gt = np.zeros((n, 3))
    pos = np.zeros(2)
    h = 0
    dirs = np.array([[1, 0], [0, 1], [-1, 0], [0, -1]], float)
    for i in range(1, n):
        r = walk.random()
        if r < 0.6:
            prefs = [h, (h + 1) % 4, (h + 3) % 4]
        elif r < 0.8:
            prefs = [(h + 1) % 4, h, (h + 3) % 4]
        else:
            prefs = [(h + 3) % 4, h, (h + 1) % 4]
        prefs.append((h + 2) % 4)
        for cand in prefs:
            nxt = pos + dirs[cand] * step
            if np.all(np.abs(nxt) <= extent * step):
                h, pos = cand, nxt
                break
        gt[i] = [pos[0], pos[1], (h * np.pi / 2 + np.pi) % (2 * np.pi) - np.pi]

    sig = np.array([ts, ts, rs])
    odo_ij = np.stack([np.arange(n - 1), np.arange(1, n)], axis=1)
    odo_z = _between(gt[:-1], gt[1:]) + noise.normal(size=(n - 1, 3)) * sig

    cell = defaultdict(list)
    loops = []
    for i in range(n):
        key = (int(round(gt[i, 0] / step)), int(round(gt[i, 1] / step)))
        for dx_ in (-1, 0, 1):
            for dy_ in (-1, 0, 1):
                found = 0
                for j in cell.get((key[0] + dx_, key[1] + dy_), ()):
                    if i - j <= p["loop_skip"] or found >= p["max_loops_per_pose"]:
                        continue
                    d = np.hypot(gt[i, 0] - gt[j, 0], gt[i, 1] - gt[j, 1])
                    if d <= p["loop_radius"] and walk.random() < p["loop_prob"]:
                        loops.append((j, i))
                        found += 1
        cell[key].append(i)
    loop_ij = np.asarray(loops, dtype=np.int64).reshape(-1, 2)
    loop_z = _between(gt[loop_ij[:, 0]], gt[loop_ij[:, 1]])
    loop_z = loop_z + noise.normal(size=loop_z.shape) * sig

    edges = np.concatenate([odo_ij, loop_ij], axis=0).astype(np.int32)
    meas = np.concatenate([odo_z, loop_z], axis=0).astype(np.float32)
    info = np.tile(np.diag(1.0 / sig**2)[None], (len(edges), 1, 1)).astype(np.float32)
    is_loop = np.zeros(len(edges), dtype=bool)
    is_loop[len(odo_ij):] = True

    init = np.zeros((n, 3))
    for i in range(1, n):
        init[i] = _compose(init[i - 1], odo_z[i - 1])
    return {"dim": 2, "poses": init.astype(np.float32), "edges": edges, "measurements": meas,
            "information": info, "is_loop": is_loop, "gt": gt.astype(np.float32)}
