#!/usr/bin/env python3
"""The JAX package's distributed m3500 solves on one CPU device, the
reference numbers of chip_smoke.py's distributed gates.

Usage:  JAX_PLATFORMS=cpu python scripts/dist_gate_jax.py

Prints one JSON line per run, each with its wall time, final chi2, ATE
before and after and, for LM, lambda and the accepted steps. Every run is
graphslam_tpu.parallel on a one-device mesh, without page-window
bucketization:

  gn      dist_fused_gn_solve, 200 iterations, cg 25, pcr_levels 4,
          edge_tile 512, hvp_splits 1 (scripts/bench_all.py:207-248's
          config), the XLA loop (cg_kernel=False); chi2 without a robust
          kernel
  gn_hs3  the same at hvp_splits 3, where the bf16 hi/lo loop gathers are
          within float32 roundoff of exact, as the port multiplies
  lm      dist_fused_lm_solve, 50 iterations, cg 25, Huber 1.0 on the
          loops, pcr_levels 4, edge_tile 512, hvp_splits 1 (the K1-LM
          cell's settings); chi2 with Huber, as the solve reports it
  lm_hs3  the same at hvp_splits 3
  dist_gn dist_gn_solve (parallel/dist.py), mode pcg, cg 50, cg_tol
          1e-30, 10 iterations (scripts/bench_all.py:173-204's config)
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from graphslam_tpu import metrics  # noqa: E402
from graphslam_tpu.config import SolverConfig  # noqa: E402
from graphslam_tpu.factors import chi2, from_dataset  # noqa: E402
from graphslam_tpu.io import datasets  # noqa: E402
from graphslam_tpu.parallel import dist_gn_solve, make_mesh, shard_graph  # noqa: E402
from graphslam_tpu.parallel.dist_fused import (  # noqa: E402
    dist_fused_gn_solve,
    dist_fused_lm_solve,
)


def main() -> None:
    data = datasets.m3500()
    graph = from_dataset(data)
    p0, gt = jnp.asarray(data["poses"]), jnp.asarray(data["gt"])
    ate0 = float(metrics.ate(p0, gt))
    mesh = make_mesh(num_devices=1)

    def emit(run, t0, poses, err, **extra):
        print(json.dumps({"run": run, "seconds": time.perf_counter() - t0, "chi2": float(err),
                          "ate0": ate0, "ate": float(metrics.ate(poses, gt)), **extra}),
              flush=True)

    for hs in (1, 3):
        cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4, edge_tile=512, hvp_splits=hs)
        t0 = time.perf_counter()
        out = dist_fused_gn_solve(p0, graph, mesh, cfg, iterations=200, cg_kernel=False)
        emit("gn" if hs == 1 else "gn_hs3", t0, out, chi2(out, graph))
    for hs in (1, 3):
        cfg = SolverConfig(cg_max_iterations=25, use_huber_on_loops=True, pcr_levels=4,
                           edge_tile=512, hvp_splits=hs)
        t0 = time.perf_counter()
        out, (err, lam, n_acc) = dist_fused_lm_solve(p0, graph, mesh, cfg, iterations=50,
                                                     cg_kernel=False)
        emit("lm" if hs == 1 else "lm_hs3", t0, out, err, lam=float(lam), steps=int(n_acc))
    cfg = SolverConfig(mode="pcg", cg_max_iterations=50, cg_tol=1e-30)
    t0 = time.perf_counter()
    out = dist_gn_solve(p0, shard_graph(graph, mesh), mesh, cfg, iterations=10)
    emit("dist_gn", t0, out, chi2(out, graph))


if __name__ == "__main__":
    main()
