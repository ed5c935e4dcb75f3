#!/usr/bin/env python3
"""The JAX package's m3500 Levenberg-Marquardt + Huber runs, the reference
numbers of chip_smoke.py's LM gate.

Usage:  JAX_PLATFORMS=cpu python scripts/lm_gate_jax.py

Prints one JSON line per run, each with its wall time, final chi2 (Huber
on the loop edges), final lambda, step count, converged flag and ATE
before and after:

  fused   graphslam_tpu.ops.gn_kernel.fused_lm_solve: 50 LM iterations,
          cg 25, huber_delta 1.0, pcr_levels 4 (scripts/bench_all.py's LM
          config), the Pallas kernel in interpret mode; "steps" counts the
          accepted ones
  loop    graphslam_tpu.solver.lm.lm_solve with mode "pcg_fused"
          (_lm_loop with the fused PCG kernel), 50 iterations, cg 25,
          Huber on loops; "steps" counts the loop's iterations
"""

import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import jax.numpy as jnp  # noqa: E402

from graphslam_tpu import metrics  # noqa: E402
from graphslam_tpu.config import SolverConfig  # noqa: E402
from graphslam_tpu.factors import from_dataset  # noqa: E402
from graphslam_tpu.io import datasets  # noqa: E402
from graphslam_tpu.ops.gn_kernel import fused_lm_solve  # noqa: E402
from graphslam_tpu.solver.lm import lm_solve  # noqa: E402


def main() -> None:
    data = datasets.m3500()
    graph = from_dataset(data)
    p0, gt = jnp.asarray(data["poses"]), jnp.asarray(data["gt"])
    ate0 = float(metrics.ate(p0, gt))

    t0 = time.perf_counter()
    poses, err, lam, n_acc, conv = fused_lm_solve(
        p0, graph, iterations=50, cg_iters=25, huber_delta=1.0, pcr_levels=4,
        edge_tile=512, hvp_splits=1, interpret=True,
    )
    chi2 = float(err)
    print(json.dumps({
        "run": "fused", "seconds": time.perf_counter() - t0, "chi2": chi2,
        "lam": float(lam), "steps": int(n_acc), "converged": bool(conv),
        "ate0": ate0, "ate": float(metrics.ate(poses, gt)),
    }), flush=True)

    t0 = time.perf_counter()
    cfg = SolverConfig(mode="pcg_fused", cg_max_iterations=25, use_huber_on_loops=True,
                       max_iterations=50)
    st = lm_solve(p0, graph, cfg)
    chi2 = float(st.error)
    print(json.dumps({
        "run": "loop", "seconds": time.perf_counter() - t0, "chi2": chi2,
        "lam": float(st.lam), "steps": int(st.iterations), "converged": bool(st.converged),
        "ate0": ate0, "ate": float(metrics.ate(st.poses, gt)),
    }), flush=True)


if __name__ == "__main__":
    main()
