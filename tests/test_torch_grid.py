"""The port's occupancy-grid world (sim/grid.py) against the JAX package's,
on the CPU.

Tolerances: the rasterized occupancy, origin and resolution equal; the
ray-marched ranges of raycast_grid equal, beam for beam, at 1081 beams
from three poses, on the port's grid and on JAX's carried over
(tests/_torch_port.py::carry_grid): both packages truncate the cell index
toward zero, take the first hit and march half a cell a step, and the
CPU's sin and cos agree here; load_pgm of a P5 and a P2 file equal. The segment raycaster's
bounds of tests/test_grid.py:26-27 (median error < 0.05 m, 97th
percentile < 0.3 m) hold for the port too.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.frontend.projection import beam_angles as jbeam_angles
from graphslam_tpu.sim import default_world as jdefault_world
from graphslam_tpu.sim import grid as jgrid

from _torch_port import carry_grid
from graphslam_tpu_torch.config import FrontendConfig
from graphslam_tpu_torch.frontend.projection import beam_angles
from graphslam_tpu_torch.sim import default_world, load_pgm, rasterize_world, raycast, raycast_grid

POSES = [(-7.0, -5.0, 0.2), (0.5, 0.0, -1.0), (3.3, -2.1, 2.5)]


@pytest.fixture(scope="module")
def grids():
    world = default_world(device="cpu")
    return world, rasterize_world(world, 0.04), jgrid.rasterize_world(jdefault_world(), 0.04)


def test_rasterize_matches_jax(grids):
    _, gw, jgw = grids
    assert np.array_equal(gw.occ.numpy(), np.asarray(jgw.occ))
    assert np.array_equal(gw.origin.numpy(), np.asarray(jgw.origin))
    assert gw.resolution == jgw.resolution


@pytest.mark.parametrize("pose", POSES)
def test_raycast_grid_matches_jax(grids, pose):
    world, gw, jgw = grids
    cfg = FrontendConfig()
    angles = beam_angles(cfg.num_beams, cfg.fov_rad, device="cpu")
    r = raycast_grid(gw, torch.tensor(pose), angles, cfg.max_range).numpy()
    ref = np.asarray(jgrid.raycast_grid(jgw, jnp.asarray(pose, jnp.float32),
                                        jbeam_angles(cfg.num_beams, cfg.fov_rad),
                                        cfg.max_range))
    assert np.array_equal(r, ref)
    carried = raycast_grid(carry_grid(jgw), torch.tensor(pose), angles, cfg.max_range).numpy()
    assert np.array_equal(carried, ref)
    exact = raycast(world, torch.tensor(pose), angles, cfg.max_range).numpy()
    valid = exact <= cfg.max_range
    err = np.abs(r[valid] - exact[valid])
    assert np.median(err) < 0.05 and np.quantile(err, 0.97) < 0.3


@pytest.mark.parametrize("magic", ["P5", "P2"])
def test_load_pgm_matches_jax(magic, tmp_path):
    H, W = 40, 30
    img = np.full((H, W), 255, np.uint8)
    img[0, :] = img[-1, :] = img[:, 0] = img[:, -1] = 0
    img[10:14, 5:9] = 90
    path = str(tmp_path / f"map_{magic}.pgm")
    with open(path, "wb") as f:
        if magic == "P5":
            f.write(b"P5\n# test map\n%d %d\n255\n" % (W, H) + img.tobytes())
        else:
            body = "\n".join(" ".join(str(v) for v in row) for row in img)
            f.write(f"P2\n# test map\n{W} {H}\n255\n{body}\n".encode())
    gw = load_pgm(path, resolution=0.1, device="cpu")
    jgw = jgrid.load_pgm(path, resolution=0.1)
    assert gw.occ.shape == (H, W)
    assert np.array_equal(gw.occ.numpy(), np.asarray(jgw.occ))
    assert np.array_equal(gw.origin.numpy(), np.asarray(jgw.origin))
    r = raycast_grid(gw, torch.zeros(3), torch.tensor([0.0, np.pi / 2]), 30.0).numpy()
    ref = np.asarray(jgrid.raycast_grid(jgw, jnp.zeros(3), jnp.array([0.0, np.pi / 2]), 30.0))
    assert np.array_equal(r, ref)
