#!/usr/bin/env python3
"""Probe the JAX package's K7 (parallel/cg_step6.py) against its own XLA loop.

Usage:  JAX_PLATFORMS=cpu timeout 1200 python scripts/jax_k7_probe.py

Runs graphslam_tpu.parallel.dist_fused6.dist_fused6_gn_solve on
sphere(8, 10, seed 27, radius 5) at one CPU device, 2 GN iterations at cg 6
and hvp_splits 3: first through the XLA loop (cg_kernel=False), then
through the three Pallas kernels in interpret mode (cg_kernel=True), and
prints each wall time and the largest pose difference. The JAX package has
no test of these kernels; the port's K7 is held to its own plain stages
instead (tests/test_torch_cg_step6.py).
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from graphslam_tpu.config import SolverConfig  # noqa: E402
from graphslam_tpu.factors import from_dataset  # noqa: E402
from graphslam_tpu.io import datasets  # noqa: E402
from graphslam_tpu.parallel.dist import make_mesh  # noqa: E402
from graphslam_tpu.parallel.dist_fused6 import dist_fused6_gn_solve  # noqa: E402


def main() -> None:
    data = datasets.sphere(n_rings=8, poses_per_ring=10, radius=5.0, seed=27)
    graph = from_dataset(data)
    p0 = jnp.asarray(data["poses"])
    mesh = make_mesh(num_devices=1)
    cfg = SolverConfig(cg_max_iterations=6, hvp_splits=3)
    t0 = time.perf_counter()
    xla = np.asarray(dist_fused6_gn_solve(p0, graph, mesh, cfg, iterations=2, cg_kernel=False))
    print(f"XLA loop: {time.perf_counter() - t0:.1f} s", flush=True)
    t0 = time.perf_counter()
    ker = np.asarray(dist_fused6_gn_solve(p0, graph, mesh, cfg, iterations=2, cg_kernel=True))
    print(f"K7 in interpret mode: {time.perf_counter() - t0:.1f} s", flush=True)
    print(f"finite {bool(np.isfinite(ker).all())}, max |d| {float(np.abs(ker - xla).max()):.3e}",
          flush=True)


if __name__ == "__main__":
    main()
