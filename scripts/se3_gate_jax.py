#!/usr/bin/env python3
"""The JAX package's SE(3) solves, the reference numbers of chip_smoke.py's SE(3) gate.

Usage:  JAX_PLATFORMS=cpu python scripts/se3_gate_jax.py

Runs the XLA path of graphslam_tpu (the fused Pallas kernels cannot run at
these sizes in interpret mode) and prints one JSON line per run, each with
its wall time, final chi2, ATE before and after and, for LM, the final
lambda, iteration count and converged flag:

  sphere2500_gn  solver.lm._gn_loop(mode="pcg"): 20 GN iterations, cg 25,
                 cg_tol 0, tridiag (cyclic reduction) preconditioner;
                 chi2 without a robust kernel
  garage_gn      the same on datasets.garage()
  garage_lm      solver.lm.lm_solve(mode="pcg"): up to 20 LM iterations,
                 cg 25, cg_tol 0, Huber 1.0 on the loop edges; chi2 with
                 Huber
  sphere2500_lm  the same on datasets.sphere2500()

chip_smoke.py holds the port's SE(3) main paths (K4 in modes gn_fused, K5
in pcg_fused) to these numbers as JAX_SE3.
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
from graphslam_tpu.factors.linearize import chi2  # noqa: E402
from graphslam_tpu.io import datasets  # noqa: E402
from graphslam_tpu.solver.lm import _gn_loop, lm_solve  # noqa: E402


def main() -> None:
    for name, make in (("sphere2500", datasets.sphere2500), ("garage", datasets.garage)):
        data = make()
        graph = from_dataset(data)
        p0, gt = jnp.asarray(data["poses"]), jnp.asarray(data["gt"])
        ate0 = float(metrics.ate(p0, gt))
        t0 = time.perf_counter()
        cfg = SolverConfig(mode="pcg", cg_max_iterations=25, cg_tol=0.0)
        out = _gn_loop(p0, graph, cfg, "pcg", 20)
        c = float(chi2(out, graph))
        print(json.dumps({
            "run": f"{name}_gn", "seconds": time.perf_counter() - t0, "chi2": c,
            "ate0": ate0, "ate": float(metrics.ate(out, gt)),
        }), flush=True)

    for name, make in (("garage", datasets.garage), ("sphere2500", datasets.sphere2500)):
        data = make()
        graph = from_dataset(data)
        p0, gt = jnp.asarray(data["poses"]), jnp.asarray(data["gt"])
        t0 = time.perf_counter()
        cfg = SolverConfig(mode="pcg", cg_max_iterations=25, cg_tol=0.0, max_iterations=20,
                           use_huber_on_loops=True, huber_delta=1.0)
        st = lm_solve(p0, graph, cfg)
        c = float(st.error)
        print(json.dumps({
            "run": f"{name}_lm", "seconds": time.perf_counter() - t0, "chi2": c,
            "lam": float(st.lam), "iterations": int(st.iterations),
            "converged": bool(st.converged), "ate0": float(metrics.ate(p0, gt)),
            "ate": float(metrics.ate(st.poses, gt)),
        }), flush=True)


if __name__ == "__main__":
    main()
