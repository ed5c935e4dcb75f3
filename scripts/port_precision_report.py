#!/usr/bin/env python3
"""Where the PyTorch port and the JAX package may differ by more than roundoff.

Usage:  JAX_PLATFORMS=cpu python scripts/port_precision_report.py

Runs on the CPU with both packages, on the tour of
tests/test_torch_pipeline.py (361 beams in 384 points, step 0.3 m, seed 9,
a 128-keyframe map, mode gn_fused with 4 warm GN iterations at cg 12), and
prints one JSON line:

  dense_marginals  at the end of the tour: the condition number of the
                   Hessian behind the dense covariances, and how far the
                   float32 inverses (the JAX package's, the port's LU, a
                   Cholesky inverse) are from a float64 one, relative to
                   the largest entry
  loop_step_solve  at the step that commits the first loop: the JAX fused
                   GN kernel (interpret mode) against the port's plain twin
                   from identical inputs, wrapped max pose difference, at
                   (GN iterations, cg) = (4, 12), (4, 25) and (8, 50)
  surfel_covs      on the scan pair of tests/test_icp_kernel.py: the port's
                   surfel covariances against the JAX package's, with the
                   port's prefix sums (XLA's order) and with torch.cumsum
  fused_pcg        on manhattan(n, loop_prob=0.25) graphs: 25 iterations
                   of the JAX fused PCG kernel (interpret mode) and of the
                   port's twin, each against the twin run in float64 on the
                   same system, relative to the largest entry, at lam 0
                   and 1e-3
"""

import dataclasses
import json
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from graphslam_tpu.config import FrontendConfig as JFrontendConfig  # noqa: E402
from graphslam_tpu.config import SLAMConfig as JSLAMConfig  # noqa: E402
from graphslam_tpu.config import SolverConfig as JSolverConfig  # noqa: E402
from graphslam_tpu.frontend import icp as jicp  # noqa: E402
from graphslam_tpu.frontend.projection import beam_angles as jbeam_angles  # noqa: E402
from graphslam_tpu.frontend.projection import scan_to_points as jscan_to_points  # noqa: E402
from graphslam_tpu.sim import raycast as jraycast, default_world as jdefault_world  # noqa: E402
from graphslam_tpu.sim import simulate_trajectory as jsimulate  # noqa: E402
from graphslam_tpu.slam import init_state as jinit_state  # noqa: E402
from graphslam_tpu.slam import make_slam_step as jmake_slam_step  # noqa: E402
from graphslam_tpu.slam import pipeline as jpipe  # noqa: E402
from graphslam_tpu.factors import from_dataset as jfrom_dataset  # noqa: E402
from graphslam_tpu.factors.linearize import linearize as jlinearize  # noqa: E402
from graphslam_tpu.io import datasets  # noqa: E402
from graphslam_tpu.ops.pcg_kernel import fused_pcg_solve as jfused_pcg_solve  # noqa: E402
from graphslam_tpu.solver import normal_eq as jne  # noqa: E402
from graphslam_tpu.solver.lm import _gn_loop as j_gn_loop  # noqa: E402
from graphslam_tpu.solver.marginals import marginal_covariances_dense as jmarginals  # noqa: E402
from graphslam_tpu_torch.config import FrontendConfig, SLAMConfig, SolverConfig  # noqa: E402
from graphslam_tpu_torch.factors.linearize import linearize  # noqa: E402
from graphslam_tpu_torch.frontend import icp  # noqa: E402
from graphslam_tpu_torch.ops.gn_kernel import fused_gn_solve_reference  # noqa: E402
from graphslam_tpu_torch.ops.pcg_kernel import fused_pcg_solve_reference  # noqa: E402
from graphslam_tpu_torch.slam import pipeline, state as tstate  # noqa: E402
from graphslam_tpu_torch.solver.normal_eq import BlockSystem, assemble_dense, build_blocks  # noqa: E402

KW = dict(max_keyframes=128, max_factors=512, solve_iterations=4)
JCFG = JSLAMConfig(frontend=JFrontendConfig(num_beams=361, max_points=384, icp_iterations=16),
                   solver=JSolverConfig(mode="gn_fused", cg_max_iterations=12), **KW)
CFG = SLAMConfig(frontend=FrontendConfig(num_beams=361, max_points=384, icp_iterations=16),
                 solver=SolverConfig(mode="gn_fused", cg_max_iterations=12), **KW)
FIELDS = [f.name for f in dataclasses.fields(tstate.SLAMState)]


def snapshot(s) -> dict:
    return {f: np.array(getattr(s, f)) for f in FIELDS}


def as_jax(snap: dict):
    return jinit_state(JCFG).replace(**{f: jnp.asarray(v) for f, v in snap.items()})


def wrapped_max(a, b) -> float:
    d = np.asarray(a, np.float64) - np.asarray(b, np.float64)
    d[:, 2] = (d[:, 2] + np.pi) % (2 * np.pi) - np.pi
    return float(np.abs(d).max())


def rel(a, ref) -> float:
    return float(np.abs(np.asarray(a, np.float64) - ref).max() / np.abs(ref).max())


def diag_blocks(inv: np.ndarray, n: int) -> np.ndarray:
    N = inv.shape[0] // 3
    inv = inv.reshape(N, 3, N, 3)
    return np.stack([inv[k, :, k, :] for k in range(n)])


def fused_pcg_report() -> dict:
    out = {}
    for n, seed in ((150, 0), (200, 0), (260, 0), (260, 1)):
        jg = jfrom_dataset(datasets.manhattan(n_poses=n, loop_prob=0.25, seed=seed))
        p = jnp.asarray(datasets.manhattan(n_poses=n, loop_prob=0.25, seed=seed)["poses"])
        jsys = jne.build_blocks(jlinearize(p, jg), jg, n)
        arrays = [np.array(a) for a in jsys]
        for lam in (0.0, 1e-3):
            kw = dict(max_iters=25, chain_prefix=jg.chain_prefix)
            x64 = fused_pcg_solve_reference(BlockSystem(*(
                torch.from_numpy(a).double() if a.dtype == np.float32 else torch.from_numpy(a)
                for a in arrays)), torch.tensor(lam, dtype=torch.float64), **kw).numpy()
            x32 = fused_pcg_solve_reference(BlockSystem(*(torch.from_numpy(a) for a in arrays)),
                                            torch.tensor(lam), **kw).numpy()
            xj = np.asarray(jfused_pcg_solve(jsys, jnp.float32(lam), interpret=True, **kw))
            out[f"n{n}_seed{seed}_lam{lam:g}"] = {"jax_vs_f64": rel(xj, x64),
                                                  "port_vs_f64": rel(x32, x64)}
    return out


def main() -> None:
    pcg = fused_pcg_report()
    sim = jsimulate(JCFG.frontend, step_len=0.3, seed=9, odom_trans_sigma=0.02,
                    odom_rot_sigma=0.01)
    step = jmake_slam_step(JCFG)
    nosolve = jmake_slam_step(dataclasses.replace(JCFG, solve_every=10**9))
    s, loop_step = jinit_state(JCFG), None
    for t in range(len(sim["scans"])):
        od = jnp.asarray(np.zeros(3, np.float32) if t == 0 else sim["odom_deltas"][t - 1])
        before = snapshot(s)
        s, info = step(s, jnp.asarray(sim["scans"][t]), od)
        if loop_step is None and bool(info.added_loop):
            committed, _ = nosolve(as_jax(before), jnp.asarray(sim["scans"][t]), od)
            loop_step = (t, snapshot(committed))
    final = snapshot(s)

    # Dense marginals at the end of the tour.
    n = int(final["num_kf"])
    st = tstate.from_numpy(final, device="cpu")
    g = pipeline.graph_view(st, CFG, 128, loop_size=64)
    lin = linearize(st.kf_poses[:128], g)
    H = assemble_dense(build_blocks(lin, g, 128), torch.zeros(()))
    H64 = H.double()
    ref = diag_blocks(torch.linalg.inv(H64).numpy(), n)
    jax_cov = np.asarray(jmarginals(jnp.asarray(final["kf_poses"][:128]),
                                    jpipe.graph_view(as_jax(final), JCFG, 128, loop_size=64)))[:n]
    dense = {
        "condition_number": float(torch.linalg.cond(H64)),
        "jax_f32_lu_rel": rel(jax_cov, ref),
        "port_f32_lu_rel": rel(diag_blocks(torch.linalg.inv(H).numpy(), n), ref),
        "f32_cholesky_rel": rel(diag_blocks(torch.cholesky_inverse(
            torch.linalg.cholesky(H)).numpy(), n), ref),
    }

    # The solve of the first loop-closing step, from identical inputs.
    t, committed = loop_step
    n = int(committed["num_kf"])
    jst = as_jax(committed)
    jg = jpipe.graph_view(jst, JCFG, 128)
    tst = tstate.from_numpy(committed, device="cpu")
    tg = pipeline.graph_view(tst, CFG, 128)
    solves = {}
    for iters, cg in ((4, 12), (4, 25), (8, 50)):
        scfg = dataclasses.replace(JCFG.solver, cg_warm_start=True, cg_max_iterations=cg)
        a = np.asarray(j_gn_loop(jst.kf_poses[:128], jg, scfg, "gn_fused", iters))
        b = fused_gn_solve_reference(tst.kf_poses[:128], tg, iterations=iters, cg_iters=cg,
                                     warm_start=True).numpy()
        solves[f"{iters}x{cg}"] = wrapped_max(a[:n], b[:n])

    # Surfel covariances on the scan pair of tests/test_icp_kernel.py.
    fc = JFrontendConfig(num_beams=181, max_points=256)
    angles = jbeam_angles(fc.num_beams, fc.fov_rad)
    r = jraycast(jdefault_world(), jnp.asarray([-7.0, -5.0, 0.2]), angles, fc.max_range)
    p, m = (np.asarray(x) for x in jscan_to_points(r, angles, fc.min_range, fc.max_range,
                                                    fc.max_points))
    want = np.asarray(jicp.surfel_covs(jnp.asarray(p), jnp.asarray(m), 4, 1e-3))
    pt, mt = torch.from_numpy(p), torch.from_numpy(m)
    ours = icp.surfel_covs(pt, mt, 4, 1e-3).numpy()
    xla_order = icp._prefix_sum
    icp._prefix_sum = lambda x: torch.cumsum(x, dim=0)
    with_cumsum = icp.surfel_covs(pt, mt, 4, 1e-3).numpy()
    icp._prefix_sum = xla_order
    surfel = {"xla_order_max_abs": float(np.abs(ours - want).max()),
              "torch_cumsum_max_abs": float(np.abs(with_cumsum - want).max())}

    print(json.dumps({"dense_marginals": dense, "loop_step": t, "loop_step_solve": solves,
                      "surfel_covs": surfel, "fused_pcg": pcg}))


if __name__ == "__main__":
    main()
