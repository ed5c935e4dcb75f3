"""The CUDA GICP kernels (csrc/icp_kernel.cu: K2 and K8) against their twins.

Needs an NVIDIA GPU and nvcc; without a card every case skips. The file
imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_icp_kernel_cuda.py
Tolerances: one K2 iteration, H and g rtol 1e-4 atol 1e-3, stats rtol 1e-4
atol 1e-2 (tests/test_icp_kernel.py's; the kernel sums in another order);
K8 indices equal and distances rtol 1e-6 (both compute them with the same
roundings); gicp_match through the kernel against the plain path, delta
atol 5e-3 (the repo's fused-vs-XLA tolerance, tests/test_icp_kernel.py).
The one-launch entries (`icp_match`, `icp_iteration`: a persistent kernel
on one cluster) against their staged launch sequences: bit for bit.
"""

import ctypes

import numpy as np
import pytest
import torch

from graphslam_tpu_torch.config import FrontendConfig
from graphslam_tpu_torch.frontend import icp
from graphslam_tpu_torch.frontend.projection import beam_angles, scan_to_points
from graphslam_tpu_torch.ops import correspondence, icp_kernel
from graphslam_tpu_torch.sim import default_world, raycast

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


def make_inputs(dev, P=256, Q=384, seed=0):
    """tests/test_icp_kernel.py::make_inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    moved = rng.normal(size=(P, 2)).astype(f)
    jtheta = rng.normal(size=(P, 2)).astype(f)
    src_mask = rng.random(P) < 0.9
    tgt = rng.normal(size=(Q, 2)).astype(f)
    tgt_valid = rng.random(Q) < 0.85
    A = (rng.normal(size=(Q, 2, 2)) * 0.3).astype(f)
    Ct = (np.einsum("qij,qkj->qik", A, A) + 0.1 * np.eye(2)).astype(f)
    Csr = (np.abs(rng.normal(size=(P, 3))) * np.array([1.0, 0.1, 1.0])).astype(f)
    return [torch.from_numpy(a).to(dev) for a in (moved, jtheta, src_mask, tgt, tgt_valid, Ct, Csr)]


def scan_pair(dev, cfg=FrontendConfig()):
    """Full-width (1152-point) scans at two nearby poses, and their init."""
    angles = beam_angles(cfg.num_beams, cfg.fov_rad, device=dev)
    world = default_world(dev)

    def scan(pose):
        r = raycast(world, torch.tensor(pose, device=dev), angles, cfg.max_range)
        return scan_to_points(r, angles, cfg.min_range, cfg.max_range, cfg.max_points)

    tp, tm = scan([-7.0, -5.0, 0.2])
    sp, sm = scan([-6.85, -4.9, 0.27])
    return (sp, sm, tp, tm), torch.tensor([0.18, 0.05, 0.09], device=dev)


def full_width_inputs(dev):
    """K2's inputs at the main path's shapes: P = Q = 1152 real scan points."""
    (sp, sm, tp, tm), init = scan_pair(dev)
    moved, jtheta = icp_kernel._round_inputs(sp, init)
    Cs = icp.surfel_covs(sp, sm, 4, 1e-3)
    Ct = icp.surfel_covs(tp, tm, 4, 1e-3)
    Csr = icp_kernel.rotated_covs(icp_kernel._packed(Cs), init[2])
    return [moved, jtheta, sm, tp, tm, Ct, Csr]


def _close_k2(ours, ref):
    for a, b, atol in zip(ours, ref, (1e-3, 1e-3, 1e-2)):
        torch.testing.assert_close(a, b, rtol=1e-4, atol=atol)


@pytest.mark.parametrize("case", ["full_width", "aligned", "unaligned_P", "no_valid"])
def test_icp_iteration_matches_twin(dev, case):
    if case == "full_width":
        args, mc2 = full_width_inputs(dev), 1.0
    elif case == "aligned":
        args, mc2 = make_inputs(dev), 1.5
    elif case == "unaligned_P":
        args, mc2 = make_inputs(dev, P=200, Q=256, seed=1), 1.0
    else:
        args, mc2 = make_inputs(dev, seed=2), 1.0
        args[4] = torch.zeros_like(args[4])
    before = icp_kernel.fused_icp_iteration.launches
    ours = icp_kernel.fused_icp_iteration(*args, max_corr2=mc2, eps=1e-6)
    ref = icp_kernel.fused_icp_iteration_reference(*args, max_corr2=mc2, eps=1e-6)
    torch.cuda.synchronize()
    assert icp_kernel.fused_icp_iteration.launches == before + 1
    _close_k2(ours, ref)
    if case == "no_valid":
        assert float(ours[2][2]) == 0.0 and torch.all(ours[0] == 0)


@pytest.mark.parametrize("case", ["full_width", "unaligned", "ties", "no_valid", "long_Q"])
def test_nearest_neighbors_matches_twin(dev, case):
    rng = np.random.default_rng(7)
    P, Q = {"full_width": (1152, 1152), "long_Q": (300, 5000)}.get(case, (200, 300))
    src = rng.normal(size=(P, 2)).astype(np.float32)
    tgt = rng.normal(size=(Q, 2)).astype(np.float32)
    valid = rng.random(Q) < 0.8
    if case == "ties":
        src, tgt = np.round(src * 2) / 2, np.round(tgt * 2) / 2
    if case == "no_valid":
        valid[:] = False
    s, t, v = (torch.from_numpy(a).to(dev) for a in (src, tgt, valid))
    idx, d2 = correspondence.nearest_neighbors(s, t, v)
    ridx, rd2 = correspondence.nearest_neighbors_reference(s, t, v)
    torch.cuda.synchronize()
    assert torch.equal(idx, ridx)
    torch.testing.assert_close(d2, rd2, rtol=1e-6, atol=0.0)


@pytest.mark.parametrize("case", ["full_width", "unaligned", "ties", "no_valid", "long_Q",
                                  "nan_points", "inf_points"])
def test_nearest_neighbors_equals_serial_bitwise(dev, case):
    # K8 (a group of threads a point) against nn_search_serial (one thread
    # a point) bit for bit,
    # NaN distances by their bits; the index also the twin's where no
    # source point is NaN (argmin takes a NaN as the smallest)
    rng = np.random.default_rng(7)
    P, Q = {"full_width": (1152, 1152), "long_Q": (300, 5000)}.get(case, (200, 300))
    src = rng.normal(size=(P, 2)).astype(np.float32)
    tgt = rng.normal(size=(Q, 2)).astype(np.float32)
    valid = rng.random(Q) < 0.8
    if case == "ties":
        src, tgt = np.round(src * 2) / 2, np.round(tgt * 2) / 2
    if case == "no_valid":
        valid[:] = False
    if case == "nan_points":
        src[::7] = np.nan
    if case == "inf_points":
        src[::11] = np.inf
    s, t, v = (torch.from_numpy(a).to(dev) for a in (src, tgt, valid))
    idx, d2 = correspondence.nearest_neighbors(s, t, v)
    sidx, sd2 = correspondence.nearest_neighbors_serial(s, t, v)
    torch.cuda.synchronize()
    assert torch.equal(idx, sidx) and torch.equal(_bits(d2), _bits(sd2))
    if case != "nan_points":
        assert torch.equal(idx, correspondence.nearest_neighbors_reference(s, t, v)[0])


def test_nearest_neighbors_is_one_launch(dev):
    args = full_width_inputs(dev)
    src, tgt, valid = args[0], args[3], args[4]
    assert _host_launches(lambda: correspondence.nearest_neighbors(src, tgt, valid)) == {
        "cudaLaunchKernel": 1}


@pytest.mark.parametrize("early_exit", [True, False], ids=["early_exit", "fixed_length"])
def test_gicp_match_kernel_matches_plain(dev, early_exit):
    args, init = scan_pair(dev)
    before = icp_kernel.fused_icp_loop.launches
    kern = icp.gicp_match(*args, init_delta=init, iterations=32, early_exit=early_exit)
    plain = icp.gicp_match(*args, init_delta=init, iterations=32, early_exit=early_exit,
                           use_kernel=False)
    torch.cuda.synchronize()
    assert icp_kernel.fused_icp_loop.launches == before + 1
    torch.testing.assert_close(kern.delta, plain.delta, rtol=0.0, atol=5e-3)
    assert bool(kern.converged) == bool(plain.converged)
    assert bool(kern.degenerate) == bool(plain.degenerate)
    torch.testing.assert_close(kern.fitness, plain.fitness, rtol=0.05, atol=0.0)


def test_kernels_are_bitwise_repeatable(dev):
    args, init = scan_pair(dev)
    a = icp.gicp_match(*args, init_delta=init, iterations=32)
    b = icp.gicp_match(*args, init_delta=init, iterations=32)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    k2 = full_width_inputs(dev)
    for x, y in zip(icp_kernel.fused_icp_iteration(*k2, max_corr2=1.0, eps=1e-6),
                    icp_kernel.fused_icp_iteration(*k2, max_corr2=1.0, eps=1e-6)):
        assert torch.equal(x, y)


def test_wrappers_check_inputs(dev):
    args = make_inputs(dev)
    with pytest.raises(ValueError, match="float32"):
        icp_kernel.fused_icp_iteration(args[0].double(), *args[1:], max_corr2=1.0, eps=1e-6)
    with pytest.raises(ValueError, match="src_mask"):
        icp_kernel.fused_icp_iteration(*args[:2], args[2][:-1], *args[3:], max_corr2=1.0, eps=1e-6)
    with pytest.raises(ValueError, match="tgt_valid"):
        correspondence.nearest_neighbors(args[0], args[3], args[4].int())
    with pytest.raises(ValueError, match="at least one"):
        correspondence.nearest_neighbors(args[0], args[3][:0], args[4][:0])


def _bits(t: torch.Tensor) -> torch.Tensor:
    """float32 as its bits (NaNs compare equal where their bits do)."""
    return t.view(torch.int32) if t.dtype == torch.float32 else t


def _host_launches(fn, calls: int = 3):
    """{launch API: host calls a call of fn} over `calls` profiled calls."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    return {e.key: e.count / calls for e in prof.key_averages()
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")}


@pytest.fixture(scope="module")
def tour(dev):
    """Full-width scans (1152 points) of the tour that chip_smoke.py replays."""
    from graphslam_tpu_torch.sim import simulate_trajectory

    cfg = FrontendConfig()
    sim = simulate_trajectory(cfg, step_len=0.25, seed=1)
    angles = beam_angles(cfg.num_beams, cfg.fov_rad, device=dev)
    pts = {}
    for t in (0, 1, 100, 101, 200, 201):
        r = torch.from_numpy(sim["scans"][t]).to(dev)
        pts[t] = scan_to_points(r, angles, cfg.min_range, cfg.max_range, cfg.max_points)
    return pts, torch.from_numpy(sim["odom_deltas"]).to(dev)


@pytest.mark.parametrize("early_exit", [True, False], ids=["early_exit", "fixed_length"])
@pytest.mark.parametrize("t", [0, 100, 200])
def test_icp_loop_equals_staged_bitwise(tour, t, early_exit):
    pts, odom = tour
    (sp, sm), (tp, tm) = pts[t + 1], pts[t]
    Cs, Ct = icp.surfel_covs(sp, sm, 4, 1e-3), icp.surfel_covs(tp, tm, 4, 1e-3)
    runs = []
    for fn in ("icp_match", "icp_match_staged"):
        res, ctrl = icp_kernel._loop(fn, sp, sm, tp, tm, Cs, Ct, odom[t], 32, 1.0, 1e-6, 1e-5,
                                     early_exit)
        runs.append([*res, ctrl])
    torch.cuda.synchronize()
    for a, b in zip(*runs):
        assert torch.equal(_bits(a), _bits(b))
    done, rounds = runs[0][4].tolist()
    if early_exit:  # done where it converged within the 32 rounds
        assert 1 <= rounds <= 32 and (done == 1 or rounds == 32)
    else:
        assert (done, rounds) == (0, 32)


@pytest.mark.parametrize("case", ["full_width", "no_valid", "nan_points"])
def test_icp_round_equals_staged_bitwise(dev, case):
    args = full_width_inputs(dev)
    if case == "no_valid":
        args[4] = torch.zeros_like(args[4])
    if case == "nan_points":
        args[0] = args[0].clone()
        args[0][::9] = float("nan")
    a = icp_kernel.fused_icp_iteration(*args, max_corr2=1.0, eps=1e-6)
    b = icp_kernel.fused_icp_iteration_staged(*args, max_corr2=1.0, eps=1e-6)
    torch.cuda.synchronize()
    for x, y in zip(a, b):
        assert torch.equal(_bits(x), _bits(y))
    if case == "no_valid":
        assert float(a[2][2]) == 0.0 and torch.all(a[0] == 0)
    if case == "nan_points":
        assert torch.isnan(a[1]).all()


def test_icp_match_and_round_are_one_launch(dev):
    """One cluster launch a match and a round (the C entries on a prepared
    problem); the staged entries two launches a round."""
    (sp, sm, tp, tm), init = scan_pair(dev)
    Cs, Ct = icp.surfel_covs(sp, sm, 4, 1e-3), icp.surfel_covs(tp, tm, 4, 1e-3)
    prob, keep = icp_kernel._problem(sp, None, icp_kernel._packed(Cs), sm, tp, tm,
                                     icp_kernel._packed(Ct), 1.0, 1e-6, 1e-5)
    delta = init.clone()
    prob.delta = delta.data_ptr()
    lib = icp_kernel._lib()

    def match(fn):
        return lambda: getattr(lib, fn)(ctypes.byref(prob), 32, 1)
    assert _host_launches(match("icp_match")) == {"cudaLaunchKernelExC": 1}
    assert _host_launches(match("icp_match_staged")) == {"cudaLaunchKernel": 64}
    args = full_width_inputs(dev)
    prob, keep = icp_kernel._problem(args[0], args[1], args[6], args[2], args[3], args[4],
                                     icp_kernel._packed(args[5]), 1.0, 1e-6)
    assert _host_launches(lambda: lib.icp_iteration(ctypes.byref(prob))) == {
        "cudaLaunchKernelExC": 1}
    assert lib.icp_ctas(sp.shape[0]) == 16

