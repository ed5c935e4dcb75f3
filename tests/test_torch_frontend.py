"""The port's simulator and frontend against graphslam_tpu on the CPU.

Same numpy inputs through the JAX function and its torch counterpart.
Tolerances: raycast ranges atol 1e-4 (float32 trig on ~10 m rays; the two
libms differ in the last ulp of each angle), odometry deltas atol 1e-6,
projection, surfel covariances and 3x3 eigenvalues atol 1e-5 (float32
roundoff of O(1) values, with prefix sums over the scan). gicp_match's
plain path against the JAX XLA path (use_pallas=False): delta atol 1e-3,
fitness rtol 1e-3, converged and degenerate equal. The kernel path runs
on the card only (tests/test_torch_icp_kernel_cuda.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import FrontendConfig as JFrontendConfig
from graphslam_tpu.frontend import icp as jicp
from graphslam_tpu.frontend import keyframes as jkf
from graphslam_tpu.frontend.projection import beam_angles as jbeam_angles
from graphslam_tpu.frontend.projection import scan_to_points as jscan_to_points
from graphslam_tpu.geometry import se2 as jse2
from graphslam_tpu.sim import world as jworld
from graphslam_tpu_torch.config import FrontendConfig
from graphslam_tpu_torch.frontend import icp, keyframes
from graphslam_tpu_torch.frontend.projection import beam_angles, scan_to_points
from graphslam_tpu_torch.geometry import se2
from graphslam_tpu_torch.sim import world

CFG = dict(num_beams=181, max_points=256)


def _t(a):
    return torch.from_numpy(np.array(a))


def _scan(pose, cfg=JFrontendConfig(**CFG)):
    """JAX-simulated (points, mask) at `pose`, as numpy."""
    angles = jbeam_angles(cfg.num_beams, cfg.fov_rad)
    r = jworld.raycast(jworld.default_world(), jnp.asarray(pose), angles, cfg.max_range)
    p, m = jscan_to_points(r, angles, cfg.min_range, cfg.max_range, cfg.max_points)
    return np.asarray(p), np.asarray(m)


def test_config_matches_jax():
    assert FrontendConfig() == FrontendConfig(**vars(JFrontendConfig()))


def test_beam_angles_and_world():
    a = beam_angles(1081, 4.71716, device="cpu").numpy()
    np.testing.assert_allclose(a, np.asarray(jbeam_angles(1081, 4.71716)), atol=1e-6)
    np.testing.assert_array_equal(world.default_world("cpu").segments.numpy(),
                                  np.asarray(jworld.default_world().segments))
    np.testing.assert_array_equal(world.figure_eight_waypoints(),
                                  jworld.figure_eight_waypoints())
    np.testing.assert_array_equal(world._waypoint_trajectory(world.figure_eight_waypoints(), 0.3),
                                  jworld._waypoint_trajectory(jworld.figure_eight_waypoints(), 0.3))


def test_simulate_trajectory_matches_jax():
    kw = dict(step_len=0.4, seed=3, odom_trans_sigma=0.02, odom_rot_sigma=0.01)
    ours = world.simulate_trajectory(FrontendConfig(**CFG), device="cpu", **kw)
    ref = jworld.simulate_trajectory(JFrontendConfig(**CFG), **kw)
    np.testing.assert_array_equal(ours["gt_poses"], ref["gt_poses"])
    assert ours["scans"].shape == ref["scans"].shape == (len(ref["gt_poses"]), 181)
    np.testing.assert_allclose(ours["scans"], ref["scans"], atol=1e-4)
    np.testing.assert_allclose(ours["odom_deltas"], ref["odom_deltas"], atol=1e-6)


def test_raycast_batched_equals_single():
    poses = _t([[-7.0, -5.0, 0.2], [1.0, 2.0, -2.5]]).float()
    angles = beam_angles(181, 4.71716, device="cpu")
    w = world.default_world("cpu")
    both = world.raycast(w, poses, angles, 30.0)
    for k in range(2):
        assert torch.equal(both[k], world.raycast(w, poses[k], angles, 30.0))


def test_scan_to_points_matches_jax():
    rng = np.random.default_rng(0)
    ranges = rng.uniform(0.0, 35.0, 181).astype(np.float32)
    ranges[[3, 50]] = np.inf
    ranges[7] = np.nan
    ranges[9] = 0.01
    angles = np.asarray(jbeam_angles(181, 4.71716))
    p, m = scan_to_points(_t(ranges), _t(angles), 0.02, 30.0, 256)
    jp, jm = jscan_to_points(jnp.asarray(ranges), jnp.asarray(angles), 0.02, 30.0, 256)
    np.testing.assert_array_equal(m.numpy(), np.asarray(jm))
    np.testing.assert_allclose(p.numpy(), np.asarray(jp), atol=1e-5)
    with pytest.raises(ValueError, match="max_points"):
        scan_to_points(_t(ranges), _t(angles), 0.02, 30.0, 100)


def test_surfel_covs_and_normals_match_jax():
    p, m = _scan([-7.0, -5.0, 0.2])
    for hw in (2, 4):
        n, c = icp.estimate_normals(_t(p), _t(m), hw)
        jn, jc = jicp.estimate_normals(jnp.asarray(p), jnp.asarray(m), hw)
        np.testing.assert_allclose(c.numpy(), np.asarray(jc), atol=1e-5)
        # a normal's sign is arbitrary where the fit is degenerate; compare n n^T
        nn = n[:, :, None] * n[:, None, :]
        np.testing.assert_allclose(nn.numpy(), np.asarray(jn[:, :, None] * jn[:, None, :]),
                                   atol=1e-5)
        np.testing.assert_allclose(icp.surfel_covs(_t(p), _t(m), hw, 1e-3).numpy(),
                                   np.asarray(jicp.surfel_covs(jnp.asarray(p), jnp.asarray(m),
                                                               hw, 1e-3)), atol=1e-5)


def test_sym3x3_eigvals_matches_jax():
    rng = np.random.default_rng(1)
    for _ in range(20):
        A = rng.normal(size=(3, 3)).astype(np.float32)
        S = (A @ A.T + 0.1 * np.eye(3)).astype(np.float32)
        ours = icp._sym3x3_eigvals(_t(S)).numpy()
        np.testing.assert_allclose(ours, np.asarray(jicp._sym3x3_eigvals(jnp.asarray(S))),
                                   atol=1e-5)
        np.testing.assert_allclose(ours, np.linalg.eigvalsh(S.astype(np.float64)), atol=1e-4)


def test_pairwise_sqdist_transform_matrix_match_jax():
    rng = np.random.default_rng(2)
    a, b = rng.normal(size=(7, 2)).astype(np.float32), rng.normal(size=(5, 2)).astype(np.float32)
    np.testing.assert_array_equal(icp._pairwise_sqdist(_t(a), _t(b)).numpy(),
                                  np.asarray(jicp._pairwise_sqdist(jnp.asarray(a), jnp.asarray(b))))
    p = rng.normal(size=(4, 3)).astype(np.float32)
    pts = rng.normal(size=(4, 6, 2)).astype(np.float32)
    np.testing.assert_allclose(se2.transform(_t(p), _t(pts)).numpy(),
                               np.asarray(jse2.transform(jnp.asarray(p), jnp.asarray(pts))),
                               atol=1e-6)
    np.testing.assert_allclose(se2.matrix(_t(p)).numpy(), np.asarray(jse2.matrix(jnp.asarray(p))),
                               atol=1e-6)


def test_keyframes_match_jax():
    rng = np.random.default_rng(3)
    deltas = (rng.normal(size=(6, 3)) * [0.4, 0.4, 0.3]).astype(np.float32)
    cfg, jcfg = FrontendConfig(), JFrontendConfig()
    np.testing.assert_allclose(keyframes.motion_covariance(_t(deltas), cfg).numpy(),
                               np.asarray(jkf.motion_covariance(jnp.asarray(deltas), jcfg)),
                               atol=1e-7)
    fit = rng.uniform(0, 0.2, 6).astype(np.float32)
    rms = rng.uniform(0, 1, 6).astype(np.float32)
    frac = rng.uniform(0.3, 1, 6).astype(np.float32)
    conv = rng.random(6) < 0.7
    res = icp.MatchResult(_t(deltas), _t(fit), _t(rms), _t(frac), _t(conv), _t(fit), _t(~conv),
                          _t(np.zeros((6, 3, 3), np.float32)))
    jres = jicp.MatchResult(*(jnp.asarray(np.asarray(x)) for x in res))
    d, jd = keyframes.decide_keyframe(res, cfg), jkf.decide_keyframe(jres, jcfg)
    np.testing.assert_array_equal(d.is_keyframe.numpy(), np.asarray(jd.is_keyframe))
    np.testing.assert_array_equal(d.is_reliable.numpy(), np.asarray(jd.is_reliable))


@pytest.fixture(scope="module")
def scan_pair():
    """The scan pair of tests/test_icp_kernel.py::test_gicp_match_fused_vs_xla."""
    tgt_pose = np.array([-7.0, -5.0, 0.2], np.float32)
    src_pose = np.array([-6.85, -4.9, 0.27], np.float32)
    tp, tm = _scan(tgt_pose)
    sp, sm = _scan(src_pose)
    expected = np.asarray(jse2.between(jnp.asarray(tgt_pose), jnp.asarray(src_pose)))
    init = (expected + np.array([0.03, -0.03, 0.02], np.float32)).astype(np.float32)
    return (sp, sm, tp, tm), init, expected


@pytest.mark.parametrize("early_exit", [True, False], ids=["early_exit", "fixed_length"])
def test_gicp_match_plain_matches_jax_xla(scan_pair, early_exit):
    args, init, expected = scan_pair
    ref = jicp.gicp_match(*(jnp.asarray(a) for a in args), init_delta=jnp.asarray(init),
                          iterations=16, use_pallas=False, early_exit=early_exit)
    res = icp.gicp_match(*(_t(a) for a in args), init_delta=_t(init), iterations=16,
                         early_exit=early_exit)
    np.testing.assert_allclose(res.delta.numpy(), np.asarray(ref.delta), atol=1e-3)
    np.testing.assert_allclose(res.delta.numpy(), expected, atol=0.04)
    np.testing.assert_allclose(float(res.fitness), float(ref.fitness), rtol=1e-3)
    np.testing.assert_allclose(float(res.inlier_rms), float(ref.inlier_rms), rtol=1e-3)
    np.testing.assert_allclose(float(res.matched_frac), float(ref.matched_frac), rtol=1e-3)
    assert bool(res.converged) == bool(ref.converged)
    assert bool(res.degenerate) == bool(ref.degenerate)
    np.testing.assert_allclose(res.hessian.numpy(), np.asarray(ref.hessian), rtol=1e-3,
                               atol=1e-3 * float(np.abs(ref.hessian).max()))


@pytest.mark.parametrize("early_exit", [True, False], ids=["early_exit", "fixed_length"])
def test_gicp_match_picks_its_path_by_device(scan_pair, early_exit):
    """CPU tensors run the plain path; the kernel path takes CUDA tensors only
    (it is held to the plain path on the card, tests/test_torch_icp_kernel_cuda.py)."""
    args, init, _ = scan_pair
    kw = dict(init_delta=_t(init), iterations=16, early_exit=early_exit)
    auto = icp.gicp_match(*(_t(a) for a in args), **kw)
    plain = icp.gicp_match(*(_t(a) for a in args), use_kernel=False, **kw)
    for a, b in zip(auto, plain):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="CUDA"):
        icp.gicp_match(*(_t(a) for a in args), use_kernel=True, **kw)
