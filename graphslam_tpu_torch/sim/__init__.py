"""Deterministic 2D laser/robot simulator (port of graphslam_tpu/sim): a
segment world, a batched raycaster with the reference laser model (1081
beams, 270.25 deg, 30 m) and scripted trajectories for closed-loop runs,
and the occupancy-grid world (sim/grid.py), raycast by ray marching."""

from graphslam_tpu_torch.sim.world import (  # noqa: F401
    World,
    default_world,
    raycast,
    simulate_trajectory,
)
from graphslam_tpu_torch.sim.grid import (  # noqa: F401
    GridWorld,
    load_pgm,
    rasterize_world,
    raycast_grid,
)
