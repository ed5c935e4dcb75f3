"""K4 and K5 (csrc/gn6_kernel.cu) against their plain torch twins on the card,
and their one-launch entries against their staged sequences, bitwise.

Needs an NVIDIA GPU and nvcc; without a card every case skips. The file
imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gn6_kernel_cuda.py
Tolerances (float32 on both sides; the kernel sums in another order and
uses FMAs): assembled blocks and one cost pass rel 1e-5, one PCR apply rel
1e-4, one 25-step CG solve and K5 rel 1e-3; poses after 5 GN iterations
within 5e-3 over the 12 pose entries (the repo's SE(3) kernel tolerance,
tests/test_gn6_kernel.py:37), after 5 LM steps with Huber within 8e-3
(tests/test_gn6_kernel.py:87) with chi2 within 1% and the accepted steps
and converged flag equal.
"""

import ctypes

import numpy as np
import pytest
import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import from_dataset
from graphslam_tpu_torch.io import datasets
from graphslam_tpu_torch.ops import gn6_kernel as g6
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops import pcg6_kernel as p6
from graphslam_tpu_torch.solver import lm

pytestmark = pytest.mark.cuda


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


LM_ARGS = (1e-5, 10.0, 1e-10, 1e7, 1e-9, 1e-6)  # lam0, factor, min, max, abs_tol, rel_tol


def _persistent_and_staged(Kernel, p0, g, mode, levels):
    """[(poses, x or stats)] of the persistent entry and of the staged
    sequence on fresh problems: GN with warm start and a cg ramp, or LM
    with Huber 1.0."""
    runs = []
    for staged in (False, True):
        if mode == "gn":
            kern = Kernel(p0, g, -1.0, levels, cg_max=25)
            (kern.solve_staged if staged else kern.solve)(((3, 25), (2, 12)), True)
            runs.append((kern.poses.clone(), kern.x.clone()))
        else:
            kern = Kernel(p0, g, 1.0, levels, cg_max=25, lm=True)
            (kern.lm_solve_staged if staged else kern.lm_solve)(5, 25, *LM_ARGS)
            runs.append((kern.poses.clone(), kern.stats.clone()))
    torch.cuda.synchronize()
    return runs


def _launches(fn, calls: int = 3):
    """({launch API: host calls a call of fn}, {kernel: device records})
    over `calls` profiled calls. The staged kernels launch through
    cudaLaunchKernel (<<<...>>>), a cluster or cooperative launch through
    cudaLaunchKernelExC. The profiler may keep none of a session's device
    records of a kernel (seen in a process that ran several other test
    files first), so only the host's calls are counted."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    events = prof.key_averages()
    host = {e.key: e.count / calls for e in events
            if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")}
    return host, {e.key: e.count for e in events if "Problem" in e.key}


def max_err(a, b) -> float:
    return float((a - b).double().abs().max())


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small(dev):
    data = datasets.sphere(n_rings=10, poses_per_ring=10, seed=1)
    return from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)


def test_problem_struct_matches_the_c_side(dev):
    assert g6._lib().gn6_problem_size() == ctypes.sizeof(g6._Problem)


def test_stages_match_twin(small):
    g, p0 = small
    kern = g6.Gn6Kernel(p0, g, -1.0, None, cg_max=25)
    kern.system()
    sysm = g6.system_reference6(p0, kern.pk)
    assert rel_err(kern.D, sysm.D) <= 1e-5
    assert rel_err(kern.U, sysm.U) <= 1e-5
    assert rel_err(kern.b, sysm.b) <= 1e-5
    kern.factor()
    factor = g6.pcr_factor_reference6(sysm.D, sysm.U, kern.K)
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(p0.shape[0], 6))
                         .astype(np.float32)).to(p0.device)
    assert rel_err(kern.precond(v), gk.pcr_apply_reference(*factor, v)) <= 1e-4
    kern.cg(25)
    assert rel_err(kern.x, gk.cg_reference(sysm, kern.pk, factor, 25)) <= 1e-3


def _variants(g):
    E, c = g.num_edges, g.chain_prefix
    mask = g.edge_mask.clone()
    mask[E - 1] = False
    mask[c - 2] = False
    keep = torch.arange(E, device=g.device) < c
    return {
        "pcr4": (g, dict(pcr_levels=4)),
        "exact": (g, dict(pcr_levels=None)),
        "chain_only": (g.replace(edge_mask=g.edge_mask & keep), dict(pcr_levels=None)),
        "masked": (g.replace(edge_mask=mask), dict(pcr_levels=4)),
        "warm_ramp": (g, dict(pcr_levels=4, warm_start=True, cg_ramp=((3, 25), (2, 12)))),
    }


@pytest.mark.parametrize("variant", ["pcr4", "exact", "chain_only", "masked", "warm_ramp"])
def test_gn_solve_matches_twin(small, variant):
    g, p0 = small
    gg, kw = _variants(g)[variant]
    out = g6.fused_gn6_solve(p0, gg, iterations=5, cg_iters=25, **kw)
    ref = g6.fused_gn6_solve_reference(p0, gg, iterations=5, cg_iters=25, **kw)
    assert torch.isfinite(out).all()
    assert max_err(out, ref) <= 5e-3


def test_cost_pass_matches_twin(small):
    g, p0 = small
    kern = g6.Gn6Kernel(p0, g, 1.0, None, cg_max=25, lm=True)
    assert rel_err(kern.chi2(p0)[0], g6.chi2_reference6(p0, kern.pk, 1.0)) <= 1e-5


@pytest.mark.parametrize("levels", [4, None], ids=["pcr4", "pcr_exact"])
def test_lm_solve_matches_twin(small, levels):
    g, p0 = small
    kw = dict(iterations=5, cg_iters=25, huber_delta=1.0, pcr_levels=levels)
    out = g6.fused_lm6_solve(p0, g, **kw)
    ref = g6.fused_lm6_solve_reference(p0, g, **kw)
    assert torch.isfinite(out[0]).all()
    assert max_err(out[0], ref[0]) <= 8e-3
    assert abs(float(out[1]) - float(ref[1])) <= 1e-2 * float(ref[1])
    assert float(out[3]) == float(ref[3]) and float(out[4]) == float(ref[4])


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_k5_matches_twin(small, lam):
    g, p0 = small
    sysm = lm._linearized_system(p0, g, SolverConfig(use_huber_on_loops=True))
    x = p6.fused_pcg6_solve(sysm, lam, max_iters=25, chain_prefix=g.chain_prefix)
    xr = p6.fused_pcg6_solve_reference(sysm, lam, max_iters=25, chain_prefix=g.chain_prefix)
    assert rel_err(x, xr) <= 1e-3


def test_lm_loop_through_k5_matches_the_loop_through_the_twin(small):
    g, p0 = small
    cfg = SolverConfig(mode="pcg_fused", max_iterations=5, cg_max_iterations=25,
                       use_huber_on_loops=True)
    before = p6.fused_pcg6_solve.launches
    out = lm._lm_loop(p0, g, cfg, "pcg_fused")
    assert p6.fused_pcg6_solve.launches == before + int(out.iterations)
    ref = lm._lm_loop(p0.cpu(), g.to("cpu"), cfg, "pcg_fused")
    assert max_err(out.poses.cpu(), ref.poses) <= 8e-3
    assert int(out.iterations) == int(ref.iterations)


def test_main_paths_go_through_the_kernels_bitwise_repeatable(small):
    g, p0 = small
    cfg = SolverConfig(mode="gn_fused", max_iterations=5, cg_max_iterations=25,
                       use_huber_on_loops=True)
    before = g6.fused_gn6_solve.launches
    a, b = lm._gn_loop(p0, g, cfg, "gn_fused", 5), lm._gn_loop(p0, g, cfg, "gn_fused", 5)
    assert g6.fused_gn6_solve.launches == before + 2
    assert torch.equal(a, b)
    before = g6.fused_lm6_solve.launches
    a, b = lm.lm_solve(p0, g, cfg), lm.lm_solve(p0, g, cfg)
    assert g6.fused_lm6_solve.launches == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_wrappers_refuse_cpu_tensors(small):
    g, p0 = small
    with pytest.raises(ValueError, match="CUDA"):
        g6.Gn6Kernel(p0.cpu(), g.to("cpu"))
    sysm = lm._linearized_system(p0.cpu(), g.to("cpu"), SolverConfig())
    with pytest.raises(ValueError, match="CUDA"):
        p6.Pcg6Kernel(*p6._chain_and_loops(sysm, 0.0, True, g.chain_prefix, T=6), 25)
    kern = g6.Gn6Kernel(p0, g, cg_max=25)
    with pytest.raises(ValueError, match="lm=True"):
        kern.lm_solve(1, 25, 1e-5, 10.0, 1e-10, 1e7, 1e-9, 1e-6)


@pytest.mark.parametrize("mode", ["gn", "lm"])
@pytest.mark.parametrize("name", ["sphere2500", "garage"])
def test_persistent_solve_equals_staged_bitwise(dev, name, mode):
    """gn6_solve / gn6_lm_solve (one launch of 384-thread CTAs, a group of
    6 threads a row in the heavy stages: a cooperative grid of 42 CTAs at
    sphere2500, one cluster of 16 at garage) against their staged sequences
    at exact PCR."""
    data = getattr(datasets, name)()
    g, p0 = from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)
    a, b = _persistent_and_staged(g6.Gn6Kernel, p0, g, mode, None)
    assert torch.isfinite(a[0]).all() and not torch.equal(a[0], p0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_persistent_solve_is_one_launch(small):
    g, p0 = small
    for lm, name in ((False, "k6_gn_wide"), (True, "k6_lm_wide")):
        kern = g6.Gn6Kernel(p0, g, 1.0 if lm else -1.0, None, cg_max=25, lm=lm)
        host, kernels = _launches(lambda: kern.lm_solve(2, 25, *LM_ARGS) if lm
                                  else kern.solve(((2, 25),), False))
        # one cluster or cooperative launch a solve, which only the
        # persistent entry makes; the device's records, where kept, name it
        assert host == {"cudaLaunchKernelExC": 1}, host
        assert all(name in k for k in kernels) and sum(kernels.values()) <= 3, kernels


def _k5_kernel(dev, name, lam):
    data = getattr(datasets, name)()
    g, p0 = from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)
    sysm = lm._linearized_system(p0, g, SolverConfig(use_huber_on_loops=True))
    args = p6._chain_and_loops(sysm, torch.tensor(lam, device=dev), True, g.chain_prefix, T=6)
    return p6.Pcg6Kernel(*args, 25)


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_k5_equals_staged_bitwise(dev, lam):
    """gn6_pcg (one launch of K4's wide factor and CG stages: one 16-CTA
    cluster at garage) against gn6_factor + gn6_cg, and two calls."""
    kern = _k5_kernel(dev, "garage", lam)
    a = kern.solve().clone()
    b = kern.staged().clone()
    again = kern.solve().clone()
    torch.cuda.synchronize()
    assert torch.isfinite(a).all() and float(a.abs().max()) > 0
    assert torch.equal(a, b) and torch.equal(a, again)


def test_k5_is_one_launch(dev):
    kern = _k5_kernel(dev, "garage", 1e-3)
    host, kernels = _launches(kern.solve)
    assert host == {"cudaLaunchKernelExC": 1}, host
    assert all("k6_pcg_wide" in k for k in kernels) and sum(kernels.values()) <= 3, kernels
    host, _ = _launches(kern.staged)
    assert host == {"cudaLaunchKernel": 347}, host  # K = 10, cg 25: 2K + 2 + 25 (K + 3)

