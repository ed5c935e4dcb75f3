#!/usr/bin/env python3
"""The JAX package's distributed SE(3) solves on one CPU device, the
reference numbers of chip_smoke.py's SE(3) distributed gates.

Usage:  JAX_PLATFORMS=cpu python scripts/dist6_gate_jax.py

Prints one JSON line per run, each with its wall time, final chi2, ATE
before and after and, for LM, lambda and the accepted steps. Every run is
graphslam_tpu.parallel.dist_fused6 on a one-device mesh through its XLA
loop (cg_kernel=False), without page-window bucketization, at cg 25,
edge_tile 256 and exact PCR (scripts/bench_all.py:251-283's config, cut
from 80 to 20 iterations):

  sphere2500_gn      dist_fused6_gn_solve, 20 iterations, hvp_splits 1;
                     chi2 without a robust kernel
  sphere2500_gn_hs3  the same at hvp_splits 3, where the bf16 hi/lo loop
                     gathers are within float32 roundoff of exact, as the
                     port multiplies
  garage_gn, garage_gn_hs3   the same on datasets.garage()
  garage_lm          dist_fused6_lm_solve, 20 steps, Huber 1.0 on the
                     loops, hvp_splits 1; chi2 with Huber, as the solve
                     reports it
  garage_lm_hs3      the same at hvp_splits 3
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from graphslam_tpu import metrics  # noqa: E402
from graphslam_tpu.config import SolverConfig  # noqa: E402
from graphslam_tpu.factors import chi2, from_dataset  # noqa: E402
from graphslam_tpu.io import datasets  # noqa: E402
from graphslam_tpu.parallel import make_mesh  # noqa: E402
from graphslam_tpu.parallel.dist_fused6 import (  # noqa: E402
    dist_fused6_gn_solve,
    dist_fused6_lm_solve,
)

ITERS = 20


def main() -> None:
    mesh = make_mesh(num_devices=1)
    print(json.dumps({"jax": jax.__version__}), flush=True)
    for name, make in (("sphere2500", datasets.sphere2500), ("garage", datasets.garage)):
        data = make()
        graph = from_dataset(data)
        p0, gt = jnp.asarray(data["poses"]), jnp.asarray(data["gt"])
        ate0 = float(metrics.ate(p0, gt))

        def emit(run, t0, poses, err, **extra):
            print(json.dumps({"run": run, "seconds": time.perf_counter() - t0,
                              "chi2": float(err), "ate0": ate0,
                              "ate": float(metrics.ate(poses, gt)), **extra}), flush=True)

        for hs in (1, 3):
            sfx = "" if hs == 1 else "_hs3"
            cfg = SolverConfig(cg_max_iterations=25, edge_tile=256, hvp_splits=hs)
            t0 = time.perf_counter()
            out = dist_fused6_gn_solve(p0, graph, mesh, cfg, iterations=ITERS, cg_kernel=False)
            emit(f"{name}_gn{sfx}", t0, out, chi2(out, graph))
            if name != "garage":
                continue
            cfg = SolverConfig(cg_max_iterations=25, edge_tile=256, hvp_splits=hs,
                               use_huber_on_loops=True, huber_delta=1.0)
            t0 = time.perf_counter()
            out, (err, lam, n_acc) = dist_fused6_lm_solve(p0, graph, mesh, cfg,
                                                          iterations=ITERS, cg_kernel=False)
            emit(f"garage_lm{sfx}", t0, out, err, lam=float(lam), steps=int(n_acc))


if __name__ == "__main__":
    main()
