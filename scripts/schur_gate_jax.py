#!/usr/bin/env python3
"""The JAX package's partitioned Schur GN and all-pose marginals on the CPU,
the reference numbers of chip_smoke.py's Schur (24) and marginals (25)
gates.

Usage:  JAX_PLATFORMS=cpu python scripts/schur_gate_jax.py [--skip solve,gn,mesh,marginals]

Prints one JSON line per run:

  solve_<name> graphslam_tpu.solver.schur.schur_solve (jitted) at lam 1e-6,
              8 blocks, on the linearization at the initial poses of
              sphere2500 and m3500: its largest error over the largest
              entry of the float64 Cholesky solve of the same damped
              float32 Hessian (assemble_dense, cast to float64; chip_smoke.py's
              phase 23 gate)
  gn_<name>   graphslam_tpu.parallel.dist_schur.dist_schur_gn_solve on a
              one-device mesh, 10 iterations at lam 1e-6, 8 blocks
              (scripts/bench_all.py::bench_dist_schur's cases, m3500 and
              sphere2500): the separator count Q of the plan, chi2 without
              a robust kernel, ATE before and after, wall seconds
  mesh_<name> dist_schur_gn_solve, 5 iterations, 8 blocks, on a one- and
              a two-device mesh (two of the CPU's virtual devices) on
              manhattan(160, seed 26, loop_prob 0.25) (tests/test_schur.py's
              mesh-invariance graph) and manhattan(1000, seed 5)
              (scripts/bench_all.py's quick case): the wrapped largest
              difference of the poses (chip_smoke.py's two-rank check)
  marginals   marginal_covariances_all at m3500's ground-truth poses
              (5811 x 5811 loop capacitance): its largest error over the
              largest entry of a float64 inverse of the same float32
              Hessian (JAX's assemble_dense at lam 0, numpy's inverse), and
              marginal_covariance_cg (the default SolverConfig: 250 CG
              iterations) for poses 0, 1749 and 3499, each error likewise
              over the largest entry of its float64 block
"""

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
if "xla_force_host_platform_device_count" not in os.environ.get("XLA_FLAGS", ""):
    os.environ["XLA_FLAGS"] = (os.environ.get("XLA_FLAGS", "")
                               + " --xla_force_host_platform_device_count=2").strip()

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import scipy.linalg  # noqa: E402

from graphslam_tpu import metrics  # noqa: E402
from graphslam_tpu.factors import chi2, from_dataset, linearize  # noqa: E402
from graphslam_tpu.io import datasets  # noqa: E402
from graphslam_tpu.parallel import make_mesh  # noqa: E402
from graphslam_tpu.parallel.dist_schur import dist_schur_gn_solve  # noqa: E402
from graphslam_tpu.solver.marginals import (  # noqa: E402
    marginal_covariance_cg,
    marginal_covariances_all,
)
from graphslam_tpu.solver.normal_eq import assemble_dense, build_blocks  # noqa: E402
from graphslam_tpu.solver.schur import schur_plan, schur_solve  # noqa: E402

CG_POSES = (0, 1749, 3499)


def solve(name, data):
    graph = from_dataset(data)
    p0 = jnp.asarray(data["poses"])
    N = p0.shape[0]
    plan = schur_plan(np.asarray(graph.edges), N, 8)
    sys_ = build_blocks(linearize(p0, graph), graph, N)
    lam = jnp.asarray(1e-6, jnp.float32)
    dx = np.asarray(jax.jit(lambda s, l: schur_solve(plan, s, l))(sys_, lam), np.float64)
    H = np.asarray(assemble_dense(sys_, lam), np.float64)
    x64 = scipy.linalg.cho_solve(scipy.linalg.cho_factor(H, lower=True, overwrite_a=True),
                                 -np.asarray(sys_.g, np.float64).reshape(-1)).reshape(dx.shape)
    del H
    print(json.dumps({"run": f"solve_{name}", "Q": int(plan.Q),
                      "err": float(np.abs(dx - x64).max() / np.abs(x64).max())}), flush=True)


def gn(name, data):
    graph = from_dataset(data)
    p0, gt = jnp.asarray(data["poses"]), jnp.asarray(data["gt"])
    plan = schur_plan(np.asarray(graph.edges), p0.shape[0], 8)
    t0 = time.perf_counter()
    out = dist_schur_gn_solve(p0, graph, plan, make_mesh(num_devices=1), iterations=10)
    out = np.asarray(out)
    print(json.dumps({"run": f"gn_{name}", "Q": int(plan.Q), "blocks": plan.B,
                      "seconds": time.perf_counter() - t0,
                      "chi2": float(chi2(jnp.asarray(out), graph)),
                      "ate0": float(metrics.ate(p0, gt)),
                      "ate": float(metrics.ate(jnp.asarray(out), gt))}), flush=True)


def mesh(name, data):
    graph = from_dataset(data)
    p0 = jnp.asarray(data["poses"])
    plan = schur_plan(np.asarray(graph.edges), p0.shape[0], 8)
    one, two = (np.asarray(dist_schur_gn_solve(p0, graph, plan, make_mesh(num_devices=n),
                                               iterations=5), np.float64) for n in (1, 2))
    d = one - two
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    print(json.dumps({"run": f"mesh_{name}", "Q": int(plan.Q),
                      "one_vs_two": float(np.abs(d).max())}), flush=True)


def marginals():
    data = datasets.m3500()
    graph = from_dataset(data)
    gt = jnp.asarray(data["gt"])
    N = gt.shape[0]
    t0 = time.perf_counter()
    allc = np.asarray(jax.jit(marginal_covariances_all)(gt, graph))
    secs = time.perf_counter() - t0
    sys_ = build_blocks(linearize(gt, graph), graph, N)
    H = np.asarray(assemble_dense(sys_, jnp.asarray(0.0), lm_diag_scaling=False), np.float64)
    inv = np.linalg.inv(H)
    del H
    ref = inv.reshape(N, 3, N, 3)[np.arange(N), :, np.arange(N), :]
    del inv
    scale = float(np.abs(ref).max())
    cg = jax.jit(marginal_covariance_cg)
    cg_err = {}
    for k in CG_POSES:
        c = np.asarray(cg(gt, graph, jnp.int32(k)))
        cg_err[str(k)] = float(np.abs(c - ref[k]).max() / np.abs(ref[k]).max())
    print(json.dumps({"run": "marginals", "poses": N,
                      "loops": int(graph.num_edges - graph.chain_prefix),
                      "all_err": float(np.abs(allc - ref).max()) / scale,
                      "all_finite": bool(np.isfinite(allc).all()),
                      "all_seconds_with_compile": secs, "cg_err": cg_err}), flush=True)


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--skip", default="")
    skip = set(filter(None, ap.parse_args().skip.split(",")))
    if "solve" not in skip:
        solve("sphere2500", datasets.sphere2500())
        solve("m3500", datasets.m3500())
    if "gn" not in skip:
        gn("sphere2500", datasets.sphere2500())
        gn("m3500", datasets.m3500())
    if "mesh" not in skip:
        mesh("manhattan160", datasets.manhattan(n_poses=160, seed=26, loop_prob=0.25))
        mesh("manhattan1000", datasets.manhattan(n_poses=1000, seed=5))
    if "marginals" not in skip:
        marginals()


if __name__ == "__main__":
    main()
