"""The CUDA GICP kernels (csrc/icp_kernel.cu: K2 and K8) against their twins.

Needs an NVIDIA GPU and nvcc; without a card every case skips. The file
imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_icp_kernel_cuda.py
Tolerances: one K2 iteration, H and g rtol 1e-4 atol 1e-3, stats rtol 1e-4
atol 1e-2 (tests/test_icp_kernel.py's; the kernel sums in another order);
K8 indices equal and distances rtol 1e-6 (both compute them with the same
roundings); gicp_match through the kernel against the plain path, delta
atol 5e-3 (the repo's fused-vs-XLA tolerance, tests/test_icp_kernel.py).
"""

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
