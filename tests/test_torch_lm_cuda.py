"""K1's LM mode and K3 (csrc/gn_kernel.cu) against their plain torch twins.

Needs an NVIDIA GPU and nvcc; without a card every case skips. The file
imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_lm_cuda.py
Tolerances (float32 on both sides; the kernel sums in another order and
uses FMAs): one cost pass rel 1e-5; LM poses after 5 Huber steps wrapped
atol 3e-3 (the repo's LM/Huber kernel tolerance, tests/test_gn_kernel.py),
chi2 within 1%, accepted steps and converged equal; one 25-step K3 solve
rel 1e-3. K3 is one launch of a persistent kernel on a thread-block
cluster; it is held bitwise (torch.equal) to the staged gn_factor + gn_cg
sequence it replaced, on graphs up to city10000 (10000 poses: 40 row
blocks, so each of the 16 CTAs walks several).
"""

import ctypes
import math

import pytest
import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import from_dataset
from graphslam_tpu_torch.io import datasets
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops import pcg_kernel as pk
from graphslam_tpu_torch.solver import lm

pytestmark = pytest.mark.cuda


def wrapped_max(a, b) -> float:
    d = (a - b).double()
    d[:, 2] = torch.remainder(d[:, 2] + math.pi, 2 * math.pi) - math.pi
    return float(d.abs().max())


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max())


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module")
def small(dev):
    data = datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)
    return from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)


def test_problem_struct_matches_the_c_side(dev):
    assert gk._lib().gn_problem_size() == ctypes.sizeof(gk._Problem)


def test_cost_pass_matches_twin(small):
    g, p0 = small
    kern = gk.GnKernel(p0, g, 1.0, 4, cg_max=25, lm=True)
    assert rel_err(kern.chi2(p0)[0], gk.chi2_reference(p0, kern.pk, 1.0)) <= 1e-5


@pytest.mark.parametrize("levels", [4, None], ids=["pcr4", "pcr_exact"])
def test_lm_solve_matches_twin(small, levels):
    g, p0 = small
    kw = dict(iterations=5, cg_iters=25, huber_delta=1.0, pcr_levels=levels)
    out = gk.fused_lm_solve(p0, g, **kw)
    ref = gk.fused_lm_solve_reference(p0, g, **kw)
    assert torch.isfinite(out[0]).all()
    assert wrapped_max(out[0], ref[0]) <= 3e-3
    assert abs(float(out[1]) - float(ref[1])) <= 1e-2 * float(ref[1])
    assert float(out[3]) == float(ref[3]) and float(out[4]) == float(ref[4])


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_k3_matches_twin(small, lam):
    g, p0 = small
    sysm = lm._linearized_system(p0, g, SolverConfig(use_huber_on_loops=True))
    x = pk.fused_pcg_solve(sysm, lam, max_iters=25, chain_prefix=g.chain_prefix)
    xr = pk.fused_pcg_solve_reference(sysm, lam, max_iters=25, chain_prefix=g.chain_prefix)
    assert rel_err(x, xr) <= 1e-3


def test_k3_on_masked_slots_matches_twin(small):
    """Masked loop slots clipped onto node 0, as in the online graph: their
    zero blocks stay out of the CSR and the solve matches the twin."""
    g, p0 = small
    c, extra = g.chain_prefix, 500
    dev = p0.device
    gm = g.replace(
        edges=torch.cat([g.edges, torch.zeros((extra, 2), dtype=torch.int32, device=dev)]),
        measurements=torch.cat([g.measurements, torch.zeros(extra, 3, device=dev)]),
        sqrt_info=torch.cat([g.sqrt_info, torch.eye(3, device=dev).expand(extra, 3, 3)]),
        edge_mask=torch.cat([g.edge_mask, torch.zeros(extra, dtype=torch.bool, device=dev)]),
        is_loop=torch.cat([g.is_loop, torch.ones(extra, dtype=torch.bool, device=dev)]),
    )
    sysm = lm._linearized_system(p0, gm, SolverConfig())
    x = pk.fused_pcg_solve(sysm, 0.0, max_iters=25, chain_prefix=c)
    xr = pk.fused_pcg_solve_reference(sysm, 0.0, max_iters=25, chain_prefix=c)
    assert rel_err(x, xr) <= 1e-3
    live = pk.live_loops(sysm.Aij[c:])
    assert torch.equal(live, gm.edge_mask[c:])


def test_lm_loop_through_k3_matches_the_loop_through_the_twin(small):
    g, p0 = small
    cfg = SolverConfig(mode="pcg_fused", max_iterations=5, cg_max_iterations=25,
                       use_huber_on_loops=True)
    before = pk.fused_pcg_solve.launches
    out = lm._lm_loop(p0, g, cfg, "pcg_fused")
    assert pk.fused_pcg_solve.launches == before + int(out.iterations)
    ref = lm._lm_loop(p0.cpu(), g.to("cpu"), cfg, "pcg_fused")
    assert wrapped_max(out.poses.cpu(), ref.poses) <= 3e-3
    assert int(out.iterations) == int(ref.iterations)


def test_lm_solve_goes_through_the_kernel_bitwise_repeatable(small):
    g, p0 = small
    cfg = SolverConfig(mode="gn_fused", max_iterations=10, cg_max_iterations=25,
                       use_huber_on_loops=True, pcr_levels=4)
    before = gk.fused_lm_solve.launches
    a, b = lm.lm_solve(p0, g, cfg), lm.lm_solve(p0, g, cfg)
    assert gk.fused_lm_solve.launches == before + 2
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    sysm = lm._linearized_system(p0, g, cfg)
    x1 = pk.fused_pcg_solve(sysm, 1e-3, max_iters=25, chain_prefix=g.chain_prefix)
    x2 = pk.fused_pcg_solve(sysm, 1e-3, max_iters=25, chain_prefix=g.chain_prefix)
    assert torch.equal(x1, x2)


def test_wrappers_refuse_cpu_tensors(small):
    g, p0 = small
    with pytest.raises(ValueError, match="CUDA"):
        gk.GnKernel(p0.cpu(), g.to("cpu"), lm=True)
    sysm = lm._linearized_system(p0.cpu(), g.to("cpu"), SolverConfig())
    with pytest.raises(ValueError, match="CUDA"):
        pk.PcgKernel(*pk._chain_and_loops(sysm, 0.0, True, g.chain_prefix), 25)
    kern = gk.GnKernel(p0, g, cg_max=25)
    with pytest.raises(ValueError, match="lm=True"):
        kern.lm_solve(1, 25, 1e-5, 10.0, 1e-10, 1e7, 1e-9, 1e-6)


def _k3_systems(small, name):
    """(system, lam, chain prefix) of one K3 case."""
    g, p0 = small
    c, dev = g.chain_prefix, p0.device
    if name == "city10000":
        data = datasets.city10000()
        g, p0 = from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)
        c = g.chain_prefix
    elif name == "chain_only":
        g = g.replace(edge_mask=g.edge_mask & (torch.arange(g.num_edges, device=dev) < c))
    elif name == "masked":
        mask, edges = g.edge_mask.clone(), g.edges.clone()
        mask[c::2] = False
        edges[c::2] = 0  # masked slots clipped onto node 0, as in the online graph
        g = g.replace(edge_mask=mask, edges=edges)
    huber = name == "huber"
    sysm = lm._linearized_system(p0, g, SolverConfig(use_huber_on_loops=huber))
    return sysm, (1e-3 if name in ("lam", "huber") else 0.0), c


@pytest.mark.parametrize("name", ["plain", "lam", "huber", "masked", "chain_only", "city10000"])
def test_k3_persistent_equals_staged_bitwise(small, name):
    sysm, lam, c = _k3_systems(small, name)
    kern = pk.PcgKernel(*pk._chain_and_loops(sysm, lam, True, c), 25)
    a = kern.solve().clone()
    b = kern.staged().clone()
    again = kern.solve().clone()
    torch.cuda.synchronize()
    assert torch.isfinite(a).all() and a.abs().max() > 0
    assert torch.equal(a, b)
    assert torch.equal(a, again)


def test_k3_is_one_launch(small):
    from torch.profiler import ProfilerActivity, profile

    sysm, lam, c = _k3_systems(small, "plain")
    kern = pk.PcgKernel(*pk._chain_and_loops(sysm, lam, True, c), 25)
    kern.solve()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            kern.solve()
        torch.cuda.synchronize()
    # one cluster launch a solve (cudaLaunchKernelExC; the staged kernels
    # launch through cudaLaunchKernel); the device's records, where the
    # profiler kept them (it kept none of a session in a process that ran
    # several other test files first), name the persistent kernel alone
    events = prof.key_averages()
    calls = {e.key: e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")}
    assert calls == {"cudaLaunchKernelExC": 3}, calls
    launches = {e.key: e.count for e in events if "GnProblem" in e.key}
    assert all("k_pcg_persistent" in k for k in launches) and sum(launches.values()) <= 3, launches
