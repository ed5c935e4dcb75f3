"""The port's online SLAM pipeline against graphslam_tpu's, on the CPU.

One simulated tour (the one of tests/test_pipeline.py::
test_cov_refresh_on_loop_commits: 361 beams padded to 384 points,
step 0.3 m, seed 9) goes through the JAX step and through the port's
replay, with the fused GN solver (mode "gn_fused", 4 warm GN iterations at
cg 12 per keyframe, as scripts/bench_all.py's frontend config) in a
128-keyframe map. The JAX side runs graphslam_tpu's own CPU paths: the XLA
GICP loop and the fused GN kernel in interpret mode.

Tolerances:
  * keyframe and loop decisions: equal, step by step;
  * poses: wrapped atol 5e-3 after the whole replay, 2e-3 after one
    keyframe step from a carried state (the repo's GN kernel-vs-XLA
    tolerance). The step that closes the first loop is taken at 8 GN
    iterations of cg 50 on both sides, also held to 2e-3: a truncated solve
    right after a large loop correction amplifies roundoff. From identical
    inputs the JAX kernel (interpret mode, bf16 hi/lo matvec splits) and the
    port's twin end 3.3e-2 apart at 4 x cg 12, 8.6e-4 at 4 x cg 25 and
    4.1e-5 at 8 x cg 50 (scripts/port_precision_report.py); the whole step
    at 4 x cg 25, where the matched loop factor differs by roundoff too,
    ends 2.3e-3 apart;
  * sqrt-information of committed factors: rtol 1e-3 of the largest entry;
  * marginal covariances: each 3x3 block within 1e-4 of its own largest
    entry of a float64 inverse of the same float32 Hessian (the port
    inverts in float64 and rounds to float32), and, as a second check,
    within 5e-2 of the largest of the JAX package's. The JAX package
    inverts in float32 a Hessian whose condition number is ~1e8 on this
    tour, 2.9% (of the largest entry) from the float64 inverse
    (scripts/port_precision_report.py), so the two packages cannot agree
    more closely.
    On a small manhattan graph the dense marginals are held to 1e-3 of the
    largest entry of the JAX package's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import FrontendConfig as JFrontendConfig
from graphslam_tpu.config import SLAMConfig as JSLAMConfig
from graphslam_tpu.config import SolverConfig as JSolverConfig
from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.frontend.icp import MatchResult as JMatchResult
from graphslam_tpu.io import datasets
from graphslam_tpu.sim import simulate_trajectory as jsimulate
from graphslam_tpu.slam import init_state as jinit_state
from graphslam_tpu.slam import make_slam_step as jmake_slam_step
from graphslam_tpu.slam import pipeline as jpipe
from graphslam_tpu.solver.marginals import marginal_covariances_dense as jmarginals
from graphslam_tpu_torch.config import FrontendConfig, SLAMConfig, SolverConfig
from graphslam_tpu_torch.factors import from_dataset, from_numpy
from graphslam_tpu_torch.factors.linearize import linearize
from graphslam_tpu_torch.frontend.icp import MatchResult
from graphslam_tpu_torch.frontend.projection import beam_angles
from graphslam_tpu_torch.sim import default_world
from graphslam_tpu_torch.slam import pipeline, state as tstate
from graphslam_tpu_torch.solver.marginals import marginal_covariances_dense
from graphslam_tpu_torch.solver.normal_eq import assemble_dense, build_blocks

from _torch_port import carry, once_per_session, wrapped_max

KW = dict(max_keyframes=128, max_factors=512, solve_iterations=4)
JCFG = JSLAMConfig(frontend=JFrontendConfig(num_beams=361, max_points=384, icp_iterations=16),
                   solver=JSolverConfig(mode="gn_fused", cg_max_iterations=12), **KW)
CFG = SLAMConfig(frontend=FrontendConfig(num_beams=361, max_points=384, icp_iterations=16),
                 solver=SolverConfig(mode="gn_fused", cg_max_iterations=12), **KW)
FIELDS = [f.name for f in dataclasses.fields(tstate.SLAMState)]
COV_TOL = 5e-2      # against the JAX package's float32 inverse
COV_F64_TOL = 1e-4  # of each block's largest entry, against a float64 inverse


def _np_state(s) -> dict:
    # copies: the JAX step donates its state, and np.asarray may alias it
    return {f: np.array(getattr(s, f)) for f in FIELDS}


def _carry(snap: dict) -> tstate.SLAMState:
    return tstate.from_numpy(snap, device="cpu")


def _as_jax(snap: dict, cfg=JCFG):
    return jinit_state(cfg).replace(**{f: jnp.asarray(v) for f, v in snap.items()})


def _odom(sim, t):
    return np.zeros(3, np.float32) if t == 0 else sim["odom_deltas"][t - 1]


@pytest.fixture(scope="module")
def tour(tmp_path_factory):
    """The JAX step over the whole tour (with the state before every step)
    and the port's replay of the same scans, computed once per session."""
    return once_per_session("test_torch_pipeline_tour", _tour, tmp_path_factory)


def _tour():
    sim = jsimulate(JCFG.frontend, step_len=0.3, seed=9, odom_trans_sigma=0.02,
                    odom_rot_sigma=0.01)
    T = len(sim["scans"])
    step = jmake_slam_step(JCFG)
    s = jinit_state(JCFG)
    snaps, infos = [], []
    for t in range(T):
        snaps.append(_np_state(s))
        s, info = step(s, jnp.asarray(sim["scans"][t]), jnp.asarray(_odom(sim, t)))
        infos.append(jax.tree_util.tree_map(np.asarray, info))
    snaps.append(_np_state(s))
    odom = np.stack([_odom(sim, t) for t in range(T)])
    state, tinfo = pipeline.make_slam_replay(CFG, T)(
        tstate.init_state(CFG, device="cpu"), torch.from_numpy(sim["scans"].copy()),
        torch.from_numpy(odom))
    return dict(sim=sim, snaps=snaps, infos=infos, state=state, tinfo=tinfo)


def _cov_close(a, b, tol=COV_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    assert np.abs(a - b).max() <= tol * np.abs(b).max(), (np.abs(a - b).max(), np.abs(b).max())


def _blocks_close(a, b, tol=COV_F64_TOL):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    err, scale = np.abs(a - b).max(axis=(1, 2)), np.abs(b).max(axis=(1, 2))
    k = int(np.argmax(err / scale))
    assert (err <= tol * scale).all(), (k, err[k], scale[k])


def _marginals_f64(st: tstate.SLAMState, n: int) -> np.ndarray:
    """The first n diagonal blocks of a float64 inverse of the float32
    Hessian that the step's covariance refresh inverts (the occupancy bucket,
    the first cov_loop_window loop slots)."""
    B = next(b for b in pipeline._solve_buckets(CFG.max_keyframes, CFG.solve_bucket_min) if b >= n)
    g = pipeline.graph_view(st, CFG, B, loop_size=min(CFG.cov_loop_window, CFG.max_factors))
    H = assemble_dense(build_blocks(linearize(st.kf_poses[:B], g), g, B), torch.zeros(()))
    inv = np.linalg.inv(H.numpy().astype(np.float64)).reshape(B, 3, B, 3)
    return np.stack([inv[k, :, k, :] for k in range(n)])


def test_replay_matches_jax(tour):
    ji, ti, ref = tour["infos"], tour["tinfo"], tour["snaps"][-1]
    n, nl = int(ref["num_kf"]), int(ref["num_loops"])
    assert nl >= 1, "the tour committed no loop closure"
    np.testing.assert_array_equal(ti.is_keyframe.numpy(), [bool(i.is_keyframe) for i in ji])
    np.testing.assert_array_equal(ti.added_loop.numpy(), [bool(i.added_loop) for i in ji])
    np.testing.assert_array_equal(ti.num_factors.numpy(), [int(i.num_factors) for i in ji])
    np.testing.assert_allclose(ti.fitness.numpy(), [float(i.fitness) for i in ji], rtol=1e-3)
    st = tour["state"]
    assert int(st.num_kf) == n and int(st.num_loops) == nl
    assert wrapped_max(st.kf_poses[:n].numpy(), ref["kf_poses"][:n]) <= 5e-3
    np.testing.assert_array_equal(st.loop_edges[:nl].numpy(), ref["loop_edges"][:nl])
    covs = st.kf_covs[:n].numpy()
    _cov_close(covs, ref["kf_covs"][:n])
    # what tests/test_pipeline.py asks of the JAX covariances
    eig = np.linalg.eigvalsh(0.5 * (covs + np.swapaxes(covs, -1, -2)))
    assert (eig > -1e-7).all()
    assert (np.diff(np.trace(covs, axis1=-2, axis2=-1)) < 0).any()


def _pick(tour, kind: str) -> int:
    ji = tour["infos"]
    if kind == "loop":
        return next(t for t, i in enumerate(ji) if bool(i.added_loop))
    return next(t for t, i in enumerate(ji)
                if t > 40 and bool(i.is_keyframe) and not bool(i.added_loop))


@pytest.mark.parametrize("kind, iters, cg", [("loop", 8, 50), ("keyframe", 4, 12)],
                         ids=["loop", "keyframe"])
def test_step_from_carried_state(tour, kind, iters, cg):
    t = _pick(tour, kind)
    sim, before = tour["sim"], tour["snaps"][t]
    scan, odom = sim["scans"][t].copy(), _odom(sim, t).copy()
    cfg, jcfg = CFG, JCFG
    if (iters, cg) == (JCFG.solve_iterations, JCFG.solver.cg_max_iterations):
        after, jinfo = tour["snaps"][t + 1], tour["infos"][t]
    else:
        cfg = dataclasses.replace(CFG, solve_iterations=iters, solver=dataclasses.replace(
            CFG.solver, cg_max_iterations=cg))
        jcfg = dataclasses.replace(JCFG, solve_iterations=iters, solver=dataclasses.replace(
            JCFG.solver, cg_max_iterations=cg))
        js, ji = jmake_slam_step(jcfg)(_as_jax(before, jcfg), jnp.asarray(scan), jnp.asarray(odom))
        after, jinfo = _np_state(js), jax.tree_util.tree_map(np.asarray, ji)
    st, info = pipeline.make_slam_step(cfg)(_carry(before), torch.from_numpy(scan),
                                            torch.from_numpy(odom))
    assert bool(info.is_keyframe) and bool(info.added_loop) == (kind == "loop")
    assert bool(info.is_keyframe) == bool(jinfo.is_keyframe)
    assert bool(info.added_loop) == bool(jinfo.added_loop)
    assert int(info.num_kf) == int(jinfo.num_kf)
    assert int(info.num_factors) == int(jinfo.num_factors)
    assert bool(info.at_capacity) == bool(jinfo.at_capacity)
    np.testing.assert_allclose(float(info.fitness), float(jinfo.fitness), rtol=1e-3)
    np.testing.assert_allclose(info.delta.numpy(), jinfo.delta, atol=1e-3)
    n, nl = int(after["num_kf"]), int(after["num_loops"])
    assert wrapped_max(st.kf_poses[:n].numpy(), after["kf_poses"][:n]) <= 2e-3
    for f, k in (("chain_sqrt_info", n - 1), ("loop_sqrt_info", max(nl, 1))):
        a, b = getattr(st, f)[:k].numpy(), after[f][:k]
        assert np.abs(a - b).max() <= 1e-3 * np.abs(b).max(), f
    for f in ("chain_mask", "loop_mask", "loop_edges", "kf_masks", "num_kf", "num_loops"):
        np.testing.assert_array_equal(getattr(st, f).numpy(), after[f], err_msg=f)
    np.testing.assert_allclose(st.kf_points.numpy(), after["kf_points"], atol=1e-5)
    np.testing.assert_allclose(st.odom_accum.numpy(), after["odom_accum"], atol=1e-6)
    if kind == "loop":  # the loop commit refreshed every covariance
        _blocks_close(st.kf_covs[:n].numpy(), _marginals_f64(st, n))
    _cov_close(st.kf_covs[:n].numpy(), after["kf_covs"][:n])


def test_dense_marginals_match_float64_inverse(tour):
    """At the end of the tour, on the port's own map: the dense marginals
    against a float64 inverse of the same Hessian."""
    st, n = tour["state"], int(tour["state"].num_kf)
    B = next(b for b in pipeline._solve_buckets(CFG.max_keyframes, CFG.solve_bucket_min) if b >= n)
    g = pipeline.graph_view(st, CFG, B, loop_size=min(CFG.cov_loop_window, CFG.max_factors))
    ours = marginal_covariances_dense(st.kf_poses[:B], g)[:n].numpy()
    _blocks_close(ours, _marginals_f64(st, n))


def test_graph_view_matches_jax(tour):
    snap = tour["snaps"][-1]
    jst = _as_jax(snap)
    st = _carry(snap)
    for size, loop_size in ((None, None), (128, 64)):
        g = pipeline.graph_view(st, CFG, size, loop_size)
        jg = jpipe.graph_view(jst, JCFG, size, loop_size)
        assert g.chain_prefix == jg.chain_prefix
        for f in ("edges", "measurements", "sqrt_info", "edge_mask", "is_loop", "prior_idx",
                  "prior_meas", "prior_sqrt_info", "prior_mask"):
            np.testing.assert_array_equal(getattr(g, f).numpy(), np.asarray(getattr(jg, f)),
                                          err_msg=f)
    # the exported map, as io.g2o would write it
    ours, ref = pipeline.state_to_dataset(st), jpipe.state_to_dataset(jst)
    assert ours.keys() == ref.keys()
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-6, err_msg=k)


def test_marginals_dense_matches_jax():
    data = datasets.manhattan(n_poses=60, loop_prob=0.3, seed=4)
    jg = jfrom_dataset(data)
    ours = marginal_covariances_dense(torch.from_numpy(data["poses"]), carry(jg)).numpy()
    ref = np.asarray(jmarginals(jnp.asarray(data["poses"]), jg))
    assert ours.shape == ref.shape == (60, 3, 3)
    assert np.abs(ours - ref).max() <= 1e-3 * np.abs(ref).max()


def test_factor_noise_matches_jax():
    rng = np.random.default_rng(11)
    A = rng.normal(size=(3, 3))
    cov = (A @ A.T * 1e-3 + 1e-4 * np.eye(3)).astype(np.float32)
    U = pipeline._sqrt_info_from_cov(torch.from_numpy(cov)).numpy()
    np.testing.assert_allclose(U, np.asarray(jpipe._sqrt_info_from_cov(jnp.asarray(cov))),
                               rtol=1e-4, atol=1e-4 * np.abs(U).max())
    np.testing.assert_allclose(U.T.astype(np.float64) @ U, np.linalg.inv(cov.astype(np.float64)),
                               rtol=1e-2)
    H = (A @ A.T * 1e3 + np.eye(3)).astype(np.float32)
    delta = np.array([0.4, -0.1, 0.2], np.float32)
    f = lambda x: np.float32(x)  # noqa: E731
    fields = (delta, f(0.01), f(0.05), f(0.9), True, f(2.5), False, H)
    res = MatchResult(*(torch.tensor(x) for x in fields))
    jres = JMatchResult(*(jnp.asarray(x) for x in fields))
    for use in (True, False):
        ours = pipeline._factor_covariance(res, torch.from_numpy(delta), CFG.frontend,
                                           torch.tensor(use))
        ref = jpipe._factor_covariance(jres, jnp.asarray(delta), JCFG.frontend, jnp.asarray(use))
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-4, atol=1e-9)


def test_buckets_state_and_config_match_jax():
    for cap, lo in ((1024, 128), (128, 128), (100, 128), (64, 16)):
        assert pipeline._solve_buckets(cap, lo) == jpipe._solve_buckets(cap, lo)
    ours, ref = tstate.init_state(CFG, device="cpu"), jinit_state(JCFG)
    for f in FIELDS:
        a, b = getattr(ours, f), np.asarray(getattr(ref, f))
        assert tuple(a.shape) == b.shape and a.numpy().dtype == b.dtype, f
    assert int(ours.num_factors) == 0
    jc = JSLAMConfig()
    assert SLAMConfig() == SLAMConfig(**{**vars(jc), "frontend": FrontendConfig(**vars(jc.frontend)),
                                         "solver": SolverConfig(**vars(jc.solver))})


def test_scan_to_map_step_matches_jax():
    """scan_to_map_keyframes > 1: the target is the last keyframes' points
    in the last keyframe's frame (solver mode pcg, a short run)."""
    kw = dict(max_keyframes=32, max_factors=64, solve_iterations=2, scan_to_map_keyframes=3)
    jcfg = JSLAMConfig(frontend=JFrontendConfig(num_beams=181, max_points=192, icp_iterations=8),
                       solver=JSolverConfig(mode="pcg", cg_max_iterations=25), **kw)
    cfg = SLAMConfig(frontend=FrontendConfig(num_beams=181, max_points=192, icp_iterations=8),
                     solver=SolverConfig(mode="pcg", cg_max_iterations=25), **kw)
    sim = jsimulate(jcfg.frontend, step_len=0.4, seed=3)
    jstep, step = jmake_slam_step(jcfg), pipeline.make_slam_step(cfg)
    js, st = jinit_state(jcfg), tstate.init_state(cfg, device="cpu")
    for t in range(16):
        js, ji = jstep(js, jnp.asarray(sim["scans"][t]), jnp.asarray(_odom(sim, t)))
        st, ti = step(st, torch.from_numpy(sim["scans"][t].copy()),
                      torch.from_numpy(_odom(sim, t).copy()))
        assert bool(ti.is_keyframe) == bool(ji.is_keyframe), t
        np.testing.assert_allclose(float(ti.fitness), float(ji.fitness), rtol=1e-3)
    n = int(js.num_kf)
    assert int(st.num_kf) == n >= 4
    assert wrapped_max(st.kf_poses[:n].numpy(), np.asarray(js.kf_poses[:n])) <= 2e-3


def test_run_slam_matches_replay():
    fcfg = FrontendConfig(num_beams=181, max_points=192, icp_iterations=12)
    cfg = SLAMConfig(max_keyframes=64, max_factors=128, frontend=fcfg, solve_iterations=2,
                     solver=SolverConfig(mode="gn_fused", cg_max_iterations=8))
    sim = jsimulate(JFrontendConfig(num_beams=181, max_points=192), step_len=0.4, seed=3)
    scans, odom = sim["scans"][:30], sim["odom_deltas"][:29]
    s1, infos = pipeline.run_slam(scans, odom, cfg, device="cpu")
    s2, stacked = pipeline.run_slam_scan(scans, odom, cfg, device="cpu")
    for f in FIELDS:
        assert torch.equal(getattr(s1, f), getattr(s2, f)), f
    np.testing.assert_array_equal([bool(i.is_keyframe) for i in infos], stacked.is_keyframe.numpy())
    assert int(s1.num_kf) >= 5


def test_entry_points_run_on_the_card_by_default():
    """Without a device argument the entry points build on the card: without
    one they raise instead of handing back CPU tensors."""
    data = datasets.manhattan(n_poses=20, seed=0)
    calls = [
        lambda: from_dataset(data),
        lambda: from_numpy({f: np.asarray(getattr(jfrom_dataset(data), f)) for f in (
            "edges", "measurements", "sqrt_info", "edge_mask", "is_loop", "prior_idx",
            "prior_meas", "prior_sqrt_info", "prior_mask")}, 19),
        lambda: tstate.init_state(CFG),
        lambda: tstate.from_numpy(_np_state(jinit_state(JCFG))),
        lambda: beam_angles(181, 4.7),
        lambda: default_world(),
    ]
    for call in calls:
        if torch.cuda.is_available():
            out = call()
            t = out if isinstance(out, torch.Tensor) else getattr(
                out, "edges", getattr(out, "kf_poses", getattr(out, "segments", None)))
            assert t.device.type == "cuda"
        else:
            with pytest.raises((AssertionError, RuntimeError)):
                call()


def test_cov_window_beyond_dense_path_is_refused():
    with pytest.raises(NotImplementedError, match="marginal_covariances_all"):
        pipeline.make_slam_step(SLAMConfig(max_keyframes=4096))
    pipeline.make_slam_step(SLAMConfig(max_keyframes=4096, cov_every=0))
