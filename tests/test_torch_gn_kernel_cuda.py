"""The CUDA fused GN kernel (csrc/gn_kernel.cu) against its plain torch twin.

Needs an NVIDIA GPU and nvcc; without a card every case skips. The file
imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_gn_kernel_cuda.py
Tolerances (float32 on both sides; the kernel sums in another order and
uses FMAs): assembled blocks rel 1e-5, one PCR apply rel 1e-4, one 25-step
CG solve rel 1e-3, poses after whole solves wrapped atol 2e-3 (the repo's
kernel tolerance, tests/test_gn_kernel.py).
"""

import math

import numpy as np
import pytest
import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import from_dataset
from graphslam_tpu_torch.io import datasets
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.solver import lm

pytestmark = pytest.mark.cuda


def wrapped_max(a, b) -> float:
    d = (a - b).double()
    d[:, 2] = torch.remainder(d[:, 2] + math.pi, 2 * math.pi) - math.pi
    return float(d.abs().max())


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


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small(dev):
    data = datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)
    return from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)


def test_stages_match_twin(small):
    g, p0 = small
    kern = gk.GnKernel(p0, g, -1.0, 4, cg_max=25)
    kern.system()
    sysm = gk.system_reference(p0, kern.pk)
    assert rel_err(kern.D, sysm.D) <= 1e-5
    assert rel_err(kern.U, sysm.U) <= 1e-5
    assert rel_err(kern.b, sysm.b) <= 1e-5
    kern.factor()
    factor = gk.pcr_factor_reference(sysm.D, sysm.U, kern.K)
    v = torch.from_numpy(np.random.default_rng(0).normal(size=(p0.shape[0], 3))
                         .astype(np.float32)).to(p0.device)
    assert rel_err(kern.precond(v), gk.pcr_apply_reference(*factor, v)) <= 1e-4
    kern.cg(25)
    assert rel_err(kern.x, gk.cg_reference(sysm, kern.pk, factor, 25)) <= 1e-3
    kern.retract()
    torch.cuda.synchronize()
    ref = gk.retract_reference(p0, kern.x)
    assert wrapped_max(kern.poses, ref) <= 1e-5


@pytest.mark.parametrize("kw", [
    dict(pcr_levels=4),
    dict(pcr_levels=None),
    dict(pcr_levels=4, huber_delta=1.0),
    dict(pcr_levels=4, warm_start=True, cg_ramp=((3, 25), (2, 12))),
], ids=["pcr4", "pcr_exact", "huber", "warm_ramp"])
def test_solve_matches_twin(small, kw):
    g, p0 = small
    out = gk.fused_gn_solve(p0, g, iterations=5, cg_iters=25, **kw)
    ref = gk.fused_gn_solve_reference(p0, g, iterations=5, cg_iters=25, **kw)
    assert torch.isfinite(out).all()
    assert wrapped_max(out, ref) <= 2e-3


@pytest.mark.parametrize("case", ["chain_only", "masked"])
def test_solve_matches_twin_edge_cases(dev, case):
    if case == "chain_only":
        data = datasets.manhattan(n_poses=150, loop_prob=0.0, seed=0)
        g = from_dataset(data, device=dev)
    else:
        data = datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)
        g = from_dataset(data, device=dev)
        mask = g.edge_mask.clone()
        mask[g.num_edges - 1] = False
        mask[g.chain_prefix - 2] = False
        g = g.replace(edge_mask=mask)
    p0 = torch.from_numpy(data["poses"]).to(dev)
    out = gk.fused_gn_solve(p0, g, iterations=5, cg_iters=25, pcr_levels=4)
    ref = gk.fused_gn_solve_reference(p0, g, iterations=5, cg_iters=25, pcr_levels=4)
    assert wrapped_max(out, ref) <= 2e-3


def test_gn_loop_goes_through_kernel_bitwise_repeatable(small):
    g, p0 = small
    cfg = SolverConfig(mode="gn_fused", cg_max_iterations=25, pcr_levels=4)
    before = gk.fused_gn_solve.launches
    a = lm._gn_loop(p0, g, cfg, "gn_fused", 10)
    b = lm._gn_loop(p0, g, cfg, "gn_fused", 10)
    assert gk.fused_gn_solve.launches == before + 2
    assert torch.equal(a, b)


def test_wrapper_checks_inputs(small):
    g, p0 = small
    with pytest.raises(ValueError, match="float32"):
        gk.GnKernel(p0.double(), g)
    with pytest.raises(ValueError, match="graph on"):
        gk.GnKernel(p0, g.to("cpu"))
    with pytest.raises(ValueError, match="outside"):
        gk.GnKernel(p0[:-1], g)
    kern = gk.GnKernel(p0, g, cg_max=5)
    with pytest.raises(ValueError, match="cg_iters"):
        kern.cg(6)


@pytest.mark.parametrize("mode", ["gn", "lm"])
@pytest.mark.parametrize("name", ["m3500", "city10000"])
def test_persistent_solve_equals_staged_bitwise(dev, name, mode):
    """gn_solve / gn_lm_solve (one launch on a cluster: 14 CTAs at m3500, 16
    walking 40 row blocks at city10000) against their staged sequences."""
    data = getattr(datasets, name)()
    g, p0 = from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)
    a, b = _persistent_and_staged(gk.GnKernel, p0, g, mode, 4)
    assert torch.isfinite(a[0]).all() and not torch.equal(a[0], p0)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1], b[1])


def test_persistent_solve_is_one_launch(small):
    g, p0 = small
    for lm, name in ((False, "k_gn_persistent"), (True, "k_lm_persistent")):
        kern = gk.GnKernel(p0, g, 1.0 if lm else -1.0, 4, cg_max=25, lm=lm)
        host, kernels = _launches(lambda: kern.lm_solve(2, 25, *LM_ARGS) if lm
                                  else kern.solve(((2, 25),), False))
        # one cluster or cooperative launch a solve, which only the
        # persistent entry makes; the device's records, where kept, name it
        assert host == {"cudaLaunchKernelExC": 1}, host
        assert all(name in k for k in kernels) and sum(kernels.values()) <= 3, kernels
