"""sphere2500-style SE(3) pose graph: a latitude spiral on a sphere.

A copy of the construction in graphslam_tpu_torch/io/datasets.py::sphere,
kept here so that the yardstick does not move with the program. The graph
(rings of poses, odometry along the spiral, loops to the ring above) is
fixed by the configuration; the run's seed draws the noise of the
measurements. Poses are (N, 12): the rotation row-major, then the
translation.
"""

from __future__ import annotations

import numpy as np


def _so3_exp(w):
    theta = np.linalg.norm(w, axis=-1, keepdims=True)
    axis = w / np.maximum(theta, 1e-12)
    K = np.zeros(w.shape[:-1] + (3, 3))
    K[..., 0, 1], K[..., 0, 2] = -axis[..., 2], axis[..., 1]
    K[..., 1, 0], K[..., 1, 2] = axis[..., 2], -axis[..., 0]
    K[..., 2, 0], K[..., 2, 1] = -axis[..., 1], axis[..., 0]
    th = theta[..., None]
    return np.eye(3) + np.sin(th) * K + (1 - np.cos(th)) * (K @ K)


def _between(a, b):
    Ra, ta = a[..., :9].reshape(-1, 3, 3), a[..., 9:]
    Rb, tb = b[..., :9].reshape(-1, 3, 3), b[..., 9:]
    Rab = np.swapaxes(Ra, -1, -2) @ Rb
    tab = np.einsum("nij,nj->ni", np.swapaxes(Ra, -1, -2), tb - ta)
    return np.concatenate([Rab.reshape(-1, 9), tab], axis=-1)


def _compose(a, b):
    Ra, ta = a[..., :9].reshape(-1, 3, 3), a[..., 9:]
    Rb, tb = b[..., :9].reshape(-1, 3, 3), b[..., 9:]
    return np.concatenate([(Ra @ Rb).reshape(-1, 9), np.einsum("nij,nj->ni", Ra, tb) + ta], -1)


def make(p: dict, seed: int) -> dict:
    """The map of `seed`, as generators/manhattan.py's `make`."""
    rings, per = int(p["n_rings"]), int(p["poses_per_ring"])
    radius, ts, rs = float(p["radius"]), float(p["trans_sigma"]), float(p["rot_sigma"])
    noise = np.random.default_rng(seed % 2**64)
    n = rings * per
    idx = np.arange(n)
    ring, k = idx // per, idx % per
    lat = -np.pi / 2 + (ring + 0.5) / rings * np.pi
    lon = 2 * np.pi * (k + 0.5 * ring) / per
    t = np.stack([radius * np.cos(lat) * np.cos(lon), radius * np.cos(lat) * np.sin(lon),
                  radius * np.sin(lat)], axis=-1)
    nrm = t / np.linalg.norm(t, axis=-1, keepdims=True)
    d_lon = np.stack([-np.sin(lon), np.cos(lon), np.zeros_like(lon)], axis=-1)
    fwd = d_lon - (d_lon * nrm).sum(-1, keepdims=True) * nrm
    fwd /= np.linalg.norm(fwd, axis=-1, keepdims=True)
    R = np.stack([fwd, np.cross(nrm, fwd), nrm], axis=-1)
    gt = np.concatenate([R.reshape(n, 9), t], axis=-1)

    def perturb(z):
        dR = _so3_exp(noise.normal(size=(len(z), 3)) * rs)
        dt = noise.normal(size=(len(z), 3)) * ts
        return _compose(z, np.concatenate([dR.reshape(-1, 9), dt], axis=-1))

    odo_ij = np.stack([idx[:-1], idx[1:]], axis=1)
    odo_z = perturb(_between(gt[:-1], gt[1:]))
    loop_i = idx[idx < n - per]
    loop_ij = np.stack([loop_i, loop_i + per], axis=1)
    loop_z = perturb(_between(gt[loop_i], gt[loop_i + per]))

    edges = np.concatenate([odo_ij, loop_ij], axis=0).astype(np.int32)
    meas = np.concatenate([odo_z, loop_z], axis=0).astype(np.float32)
    info_diag = np.concatenate([np.full(3, 1.0 / ts**2), np.full(3, 1.0 / rs**2)])
    info = np.tile(np.diag(info_diag)[None], (len(edges), 1, 1)).astype(np.float32)
    is_loop = np.zeros(len(edges), dtype=bool)
    is_loop[len(odo_ij):] = True

    init = np.zeros((n, 12))
    init[0] = gt[0]
    for i in range(1, n):
        init[i] = _compose(init[i - 1:i], odo_z[i - 1:i])[0]
    return {"dim": 3, "poses": init.astype(np.float32), "edges": edges, "measurements": meas,
            "information": info, "is_loop": is_loop, "gt": gt.astype(np.float32)}
