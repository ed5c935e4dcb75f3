"""The port's marginal covariances (solver/marginals.py) against the JAX
package's, on the CPU, and the online pipeline's refresh above the dense
limit.

The same seeded graphs go to both packages (tests/_torch_port.py::carry),
at the ground-truth poses; the JAX functions run jitted on the XLA CPU
backend, once a signature.

Tolerances:
  * marginal_covariances_all: against the port's float64 dense marginals
    at the JAX test's tolerance (atol 5e-4 of the largest entry, rtol 2e-2,
    tests/test_marginals.py:45-47), as JAX's own result is; against JAX's
    at twice that atol (each float32 Woodbury sum is ~3e-4 of the largest
    entry from the float64 one, in its own direction);
  * marginal_covariance_cg: rtol 1e-3, atol 1e-6 against JAX's (measured
    4e-5 of the largest entry) and the JAX test's 5e-2, 1e-5 against the
    dense block (tests/test_marginals.py:22);
  * the refresh above the dense limit (_DENSE_COV_MAX patched to 32, a
    64-pose bucket): every refresh takes marginal_covariances_all and
    writes its result. On an online map the float32 Woodbury subtraction
    cancels (the JAX pipeline's own note, graphslam_tpu/slam/pipeline.py:
    449-457): on this tour JAX's marginal_covariances_all is 1.6-6.7% of
    the largest entry from the float64 dense refresh, and the port's 1.4-
    7.2%, so the JAX test's tolerance cannot hold for either package. The
    port's largest error over the refreshes is held to at most twice
    JAX's, on the same graphs (chip_smoke.py's marginals gate).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.graph import FactorGraph as JFactorGraph
from graphslam_tpu.io import datasets
from graphslam_tpu.solver import marginals as jmarginals

from _torch_port import FIELDS, carry
from graphslam_tpu_torch.config import FrontendConfig, SLAMConfig, SolverConfig
from graphslam_tpu_torch.sim import simulate_trajectory
from graphslam_tpu_torch.slam import pipeline
from graphslam_tpu_torch.solver import marginals
from graphslam_tpu_torch.solver.marginals import (
    marginal_covariance_cg,
    marginal_covariances_all,
    marginal_covariances_dense,
)

JAX_ALL = jax.jit(jmarginals.marginal_covariances_all)
JAX_CG = jax.jit(jmarginals.marginal_covariance_cg)


def _graph(**kw):
    data = datasets.manhattan(**kw)
    jg = jfrom_dataset(data)
    return data, jg, carry(jg), torch.from_numpy(np.asarray(data["gt"]))


@pytest.mark.parametrize("kw", [dict(n_poses=120, loop_prob=0.25, seed=19),
                                dict(n_poses=80, loop_prob=0.0, seed=20)],
                         ids=["loops", "chain_only"])
def test_all_pose_marginals_match_jax(kw):
    data, jg, g, gt = _graph(**kw)
    out = marginal_covariances_all(gt, g).numpy()
    ref = np.asarray(JAX_ALL(jnp.asarray(data["gt"]), jg))
    dense = marginal_covariances_dense(gt, g).numpy()
    scale = np.abs(dense).max()
    np.testing.assert_allclose(out, dense, atol=5e-4 * scale, rtol=2e-2)
    np.testing.assert_allclose(out, ref, atol=1e-3 * scale, rtol=2e-2)


def test_cg_marginals_match_jax():
    data, jg, g, gt = _graph(n_poses=60, seed=17)
    dense = marginal_covariances_dense(gt, g).numpy()
    for k in (7, 59):
        out = marginal_covariance_cg(gt, g, k).numpy()
        ref = np.asarray(JAX_CG(jnp.asarray(data["gt"]), jg, jnp.int32(k)))
        np.testing.assert_allclose(out, ref, rtol=1e-3, atol=1e-6)
        np.testing.assert_allclose(out, dense[k], rtol=5e-2, atol=1e-5)


def test_pipeline_refresh_above_dense_limit(monkeypatch):
    fc = FrontendConfig(num_beams=181, max_points=192, icp_iterations=8)
    cfg = SLAMConfig(max_keyframes=128, max_factors=128, solve_bucket_min=16,
                     solve_iterations=2, frontend=fc,
                     solver=SolverConfig(mode="pcg", cg_max_iterations=10))
    sim = simulate_trajectory(fc, step_len=1.0, seed=9, device="cpu")
    calls, dense_sizes = [], []

    def spy_all(poses, graph):
        out = marginal_covariances_all(poses, graph)
        calls.append((poses.clone(), graph, out))
        return out

    def spy_dense(poses, graph):
        dense_sizes.append(poses.shape[0])
        return marginal_covariances_dense(poses, graph)

    monkeypatch.setattr(pipeline, "_DENSE_COV_MAX", 32)
    monkeypatch.setattr(marginals, "marginal_covariances_all", spy_all)
    monkeypatch.setattr(marginals, "marginal_covariances_dense", spy_dense)
    state, infos = pipeline.run_slam_scan(sim["scans"][:62], sim["odom_deltas"], cfg,
                                          device="cpu")
    # the tour's first loops close at scans 56-61, in the 64-pose bucket
    assert int(state.num_loops) >= 3 and len(calls) == int(state.num_loops)
    assert not dense_sizes
    B = calls[-1][0].shape[0]
    assert B == 64 and torch.equal(state.kf_covs[:B], calls[-1][2])
    errs, jax_errs = [], []
    for poses, graph, out in calls:
        assert torch.isfinite(out).all()
        dense = marginal_covariances_dense(poses, graph).numpy()
        jg = JFactorGraph(**{f: jnp.asarray(getattr(graph, f).numpy()) for f in FIELDS},
                          chain_prefix=graph.chain_prefix)
        ref = np.asarray(JAX_ALL(jnp.asarray(poses.numpy()), jg))
        scale = np.abs(dense).max()
        errs.append(np.abs(out.numpy() - dense).max() / scale)
        jax_errs.append(np.abs(ref - dense).max() / scale)
    assert max(errs) <= 2 * max(jax_errs), (errs, jax_errs)
