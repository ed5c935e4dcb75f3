"""Occupancy-grid (bitmap) world, the Stage floorplan model: port of
graphslam_tpu/sim/grid.py.

The reference's Stage world is a raster floorplan (willow.pgm at 0.02 m
raytrace resolution, willow.world:46,62-67). A boolean occupancy grid is
raycast by fixed-step ray marching: one dense (beams, steps) gather and a
first-hit argmax, no data-dependent control flow. Grids come from PGM files
(`load_pgm`: point it at any Stage map) or by rasterizing a segment world
(`rasterize_world`); both are made on the host in numpy, as the JAX package
makes them, and moved to the device once.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from graphslam_tpu_torch.sim.world import World


class GridWorld(NamedTuple):
    occ: torch.Tensor       # (H, W) bool, True = occupied
    resolution: float       # meters per cell
    origin: torch.Tensor    # (2,) world position of cell (0, 0)'s corner


def load_pgm(path: str, resolution: float, occupied_below: int = 128,
             device="cuda") -> GridWorld:
    """Minimal P2/P5 PGM reader; dark pixels are obstacles (Stage semantics).
    The grid is centered on the world origin like Stage's floorplan model."""
    with open(path, "rb") as f:
        data = f.read()
    # Header: magic, dims, maxval — comments allowed.
    tokens = []
    i = 0
    while len(tokens) < 4:
        # skip whitespace/comments
        while i < len(data) and data[i : i + 1].isspace():
            i += 1
        if data[i : i + 1] == b"#":
            while i < len(data) and data[i : i + 1] != b"\n":
                i += 1
            continue
        j = i
        while j < len(data) and not data[j : j + 1].isspace():
            j += 1
        tokens.append(data[i:j])
        i = j
    magic, w, h, maxval = tokens[0], int(tokens[1]), int(tokens[2]), int(tokens[3])
    i += 1  # single whitespace after maxval
    if magic == b"P5":
        img = np.frombuffer(data[i : i + w * h], dtype=np.uint8).reshape(h, w)
    elif magic == b"P2":
        img = np.array(data[i:].split()[: w * h], dtype=np.int64).reshape(h, w)
    else:
        raise ValueError(f"unsupported PGM magic {magic!r}")
    occ = img < occupied_below * (maxval / 255.0)
    occ = occ[::-1]  # image rows go top-down; grid rows go +y
    H, W = occ.shape
    origin = np.array([-W * resolution / 2.0, -H * resolution / 2.0], np.float32)
    return GridWorld(
        occ=torch.from_numpy(np.ascontiguousarray(occ)).to(device),
        resolution=resolution,
        origin=torch.from_numpy(origin).to(device),
    )


def rasterize_world(world: World, resolution: float = 0.05, pad: float = 1.0) -> GridWorld:
    """Draw a segment world into an occupancy grid (host-side), on the
    world's device."""
    segs = world.segments.cpu().numpy()
    lo = segs.reshape(-1, 2).min(axis=0) - pad
    hi = segs.reshape(-1, 2).max(axis=0) + pad
    W = int(np.ceil((hi[0] - lo[0]) / resolution))
    H = int(np.ceil((hi[1] - lo[1]) / resolution))
    occ = np.zeros((H, W), bool)
    for (a, b) in segs:
        n = max(2, int(np.ceil(np.linalg.norm(b - a) / (0.5 * resolution))))
        pts = a[None] + (b - a)[None] * np.linspace(0, 1, n)[:, None]
        ix = np.clip(((pts[:, 0] - lo[0]) / resolution).astype(int), 0, W - 1)
        iy = np.clip(((pts[:, 1] - lo[1]) / resolution).astype(int), 0, H - 1)
        occ[iy, ix] = True
    dev = world.segments.device
    return GridWorld(
        occ=torch.from_numpy(occ).to(dev),
        resolution=resolution,
        origin=torch.from_numpy(lo.astype(np.float32)).to(dev),
    )


def raycast_grid(
    gw: GridWorld, pose: torch.Tensor, angles: torch.Tensor, max_range: float
) -> torch.Tensor:
    """Fixed-step ray marching: (B,) ranges. Steps at half the cell size keep
    the first-hit error below one resolution cell. Cell indices truncate
    toward zero (as `.astype(int32)` does) and the first hit along a ray is
    the first maximum of argmax."""
    step = gw.resolution * 0.5
    n_steps = int(np.ceil(max_range / step))
    rs = torch.arange(1, n_steps + 1, dtype=pose.dtype, device=pose.device) * step   # (S,)
    th = pose[2] + angles
    px = pose[0] + torch.cos(th)[:, None] * rs[None, :]                            # (B, S)
    py = pose[1] + torch.sin(th)[:, None] * rs[None, :]
    H, W = gw.occ.shape
    ix = torch.clamp(((px - gw.origin[0]) / gw.resolution).to(torch.int32), 0, W - 1)
    iy = torch.clamp(((py - gw.origin[1]) / gw.resolution).to(torch.int32), 0, H - 1)
    hit = gw.occ[iy.long(), ix.long()].to(torch.int32)                              # (B, S)
    first = torch.argmax(hit, dim=1)
    r = rs[first]
    return torch.where(hit.amax(dim=1) > 0, r, torch.full_like(r, max_range + 1.0))
