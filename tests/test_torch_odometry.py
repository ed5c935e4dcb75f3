"""The port's odometry buffer (slam/odometry.py), its twist-driven replay
(slam/pipeline.py::run_slam_from_twists) and its replay logs (io/logs.py)
against the JAX package's, on the CPU.

The buffer is driven by the twists of tests/test_pipeline.py's buffer tests
(straight then turning, a twist with rotation, a ring that wraps) through
both packages; JAX's integrate_twist and query_interval run jitted. The
twist replay is held to JAX's buffer functions, not to JAX's whole
run_slam_from_twists (a pipeline compile), as
tests/test_pipeline.py::test_twist_factor_covariance_comes_from_odometry_buffer
holds JAX's own.

Tolerances:
  * buffer fields after every tick: stamps, validity and head equal; poses
    and covariances atol 1e-6 (float32 roundoff of ~10 composed steps);
  * query_interval, scalar and batched stamps, on the port's buffer and on
    JAX's buffer carried over (tests/_torch_port.py::carry_buffer): delta
    atol 1e-6, covariance atol 1e-7 (entries ~1e-2);
  * the twist replay's committed chain factors: measurement atol 1e-4 and
    covariance rtol 2e-2, atol 1e-5 against JAX's query_interval between
    the keyframe stamps (tests/test_pipeline.py:264-272);
  * logs: every array bitwise, every scalar equal, both ways.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import FrontendConfig as JFrontendConfig
from graphslam_tpu.io import logs as jlogs
from graphslam_tpu.slam import odometry as jodo

from _torch_port import carry_buffer
from graphslam_tpu_torch.config import FrontendConfig, SLAMConfig, SolverConfig
from graphslam_tpu_torch.io import logs
from graphslam_tpu_torch.slam.odometry import init_buffer, integrate_twist, query_interval
from graphslam_tpu_torch.slam.pipeline import run_slam_from_twists

JAX_INTEGRATE = jax.jit(jodo.integrate_twist, static_argnums=(4,))
JAX_QUERY = jax.jit(jodo.query_interval, static_argnums=(3,))
FIELDS = ("times", "poses", "covs", "valid", "head", "pose", "cov")

# (depth, [(twist, ticks)], dt): tests/test_pipeline.py:26-79
DRIVES = {
    "straight_then_turn": (64, [((1.0, 0.0, 0.0), 10), ((0.0, 0.0, 0.8), 6)], 0.1),
    "rotating_twist": (64, [((1.0, 0.2, 0.3), 12)], 0.1),
    "ring_wraps": (8, [((0.5, 0.0, 0.1), 20)], 0.1),
}


def _check_buffer(buf, jbuf):
    for f in FIELDS:
        a, b = getattr(buf, f).numpy(), np.asarray(getattr(jbuf, f))
        if f in ("times", "valid", "head"):
            assert np.array_equal(a, b), f
        else:
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f)


@pytest.mark.parametrize("drive", sorted(DRIVES))
def test_buffer_matches_jax(drive):
    depth, legs, dt = DRIVES[drive]
    fc, jfc = FrontendConfig(), JFrontendConfig()
    buf, jbuf = init_buffer(depth=depth, device="cpu"), jodo.init_buffer(depth=depth)
    k = 0
    for tw, ticks in legs:
        tw = np.asarray(tw, np.float32)
        for _ in range(ticks):
            t = np.float32(k * dt)
            buf = integrate_twist(buf, torch.from_numpy(tw), np.float32(dt), float(t), fc)
            jbuf = JAX_INTEGRATE(jbuf, jnp.asarray(tw), jnp.float32(dt), jnp.float32(t), jfc)
            _check_buffer(buf, jbuf)
            k += 1
    stamps = np.float32(dt) * np.arange(k, dtype=np.float32)
    t0 = np.array([stamps[0], stamps[k // 3], stamps[k // 2] + 0.04], np.float32)
    t1 = np.array([stamps[k - 1], stamps[k - 2], stamps[k - 1] - 0.03], np.float32)
    deltas, covs = query_interval(buf, torch.from_numpy(t0), torch.from_numpy(t1), fc)
    carried = carry_buffer(jbuf)  # the queries alone, on JAX's own buffer
    for i in range(len(t0)):
        jd, jq = JAX_QUERY(jbuf, jnp.float32(t0[i]), jnp.float32(t1[i]), jfc)
        d, q = query_interval(buf, float(t0[i]), float(t1[i]), fc)
        dc, qc = query_interval(carried, float(t0[i]), float(t1[i]), fc)
        for dd, qq in ((d, q), (deltas[i], covs[i]), (dc, qc)):
            np.testing.assert_allclose(dd.numpy(), np.asarray(jd), rtol=0, atol=1e-6)
            np.testing.assert_allclose(qq.numpy(), np.asarray(jq), rtol=0, atol=1e-7)


def test_twist_replay_factors_come_from_jax_buffer():
    # tests/test_pipeline.py::test_twist_factor_covariance_comes_from_odometry_buffer:
    # scans that never match, so the chain factors fall back to odometry
    fc = FrontendConfig(num_beams=181, max_points=192, icp_iterations=8)
    cfg = SLAMConfig(max_keyframes=64, max_factors=256, frontend=fc,
                     solver=SolverConfig(mode="pcg", cg_max_iterations=10))
    dt, T = 0.2, 12
    twists = np.tile(np.array([1.0, 0.0, 0.5], np.float32), (T - 1, 1))
    scans = np.full((T, fc.num_beams), fc.max_range + 5.0, np.float32)
    state, infos = run_slam_from_twists(scans, twists, dt, cfg, device="cpu")
    assert infos.is_keyframe.shape[0] == T
    kf_steps = np.flatnonzero(infos.is_keyframe.numpy())
    assert len(kf_steps) >= 3, kf_steps

    jfc = JFrontendConfig(**dataclasses.asdict(fc))
    jbuf = jodo.init_buffer(depth=T)
    jbuf = jbuf.replace(times=jbuf.times.at[0].set(0.0), valid=jbuf.valid.at[0].set(True),
                        head=jnp.int32(1))
    for k in range(1, T):
        jbuf = JAX_INTEGRATE(jbuf, jnp.asarray(twists[k - 1]), jnp.float32(dt),
                             jnp.float32(k * dt), jfc)
    for f, (a, b) in enumerate(zip(kf_steps[:-1], kf_steps[1:])):
        d_exp, Q_exp = JAX_QUERY(jbuf, jnp.float32(a * dt), jnp.float32(b * dt), jfc)
        si = state.chain_sqrt_info[f].numpy().astype(np.float64)
        np.testing.assert_allclose(state.chain_meas[f].numpy(), np.asarray(d_exp), atol=1e-4)
        np.testing.assert_allclose(np.linalg.inv(si.T @ si), np.asarray(Q_exp), rtol=2e-2,
                                   atol=1e-5)


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_log_roundtrip_across_packages(writer, tmp_path):
    rng = np.random.default_rng(3)
    scans = rng.uniform(0.1, 30.0, (5, 181)).astype(np.float32)
    odom = rng.normal(size=(4, 3)).astype(np.float32)
    gt = rng.normal(size=(5, 3)).astype(np.float32)
    path = str(tmp_path / "run.npz")
    if writer == "port":
        logs.save_log(path, scans, odom, gt, FrontendConfig(num_beams=181))
        got = jlogs.load_log(path)
    else:
        jlogs.save_log(path, scans, odom, gt, JFrontendConfig(num_beams=181))
        got = logs.load_log(path)
    assert np.array_equal(got["scans"], scans) and got["scans"].dtype == np.float32
    assert np.array_equal(got["odom_deltas"], odom) and np.array_equal(got["gt_poses"], gt)
    assert (got["num_beams"], got["fov_rad"], got["max_range"]) == (
        181, FrontendConfig().fov_rad, FrontendConfig().max_range)
    # optional arrays absent both ways
    path2 = str(tmp_path / "bare.npz")
    (logs.save_log if writer == "port" else jlogs.save_log)(
        path2, scans, None, None, FrontendConfig() if writer == "port" else JFrontendConfig())
    got = (jlogs if writer == "port" else logs).load_log(path2)
    assert got["odom_deltas"] is None and got["gt_poses"] is None
