"""K7a-c (csrc/cg_step6.cu) against their plain torch twins on the card.

Needs an NVIDIA GPU and nvcc; without a card every case skips. The file
imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cg_step6_cuda.py
Two ranks are emulated in one process on sphere(10, 10) and on the garage:
each holds half the loop edges, rank 0 the chain (w_chain 1), rank 1 none
(w_chain 0), and the all-reduces are sums of the two ranks' buffers; PCR
at the exact K = ceil(log2 N). Tolerances are K6's (float32 on both sides;
the kernels sum in another order and use FMAs): the payload, Aij, D and b
rel 5e-5; the PCR factor rel 1e-4; the CG state after one pass rel 1e-4,
after 26 passes rel 1e-3; the kernel path of dist_fused6_gn_solve against
the plain path on the card max |d| 5e-3 over the 12 pose entries, LM 8e-3
with accepted steps equal (tests/test_dist_fused6.py:38, :51). K7b
(`gn_setup6`) and K7c (`cg_step6`) are each one launch of a persistent
kernel (counted from the launch API, `cudaLaunchKernelExC`), bitwise equal
to the staged sequences they replaced (`gn_setup_staged`,
`cg_step_staged`): both ranks' Setups and carries after 1 and 26 passes.
"""

import ctypes

import pytest
import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import from_dataset
from graphslam_tpu_torch.io import datasets
from graphslam_tpu_torch.ops import gn6_kernel as g6
from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for
from graphslam_tpu_torch.parallel import cg_step as cs
from graphslam_tpu_torch.parallel import cg_step6 as cs6
from graphslam_tpu_torch.parallel import dist_fused6_gn_solve, dist_fused6_lm_solve, make_mesh

pytestmark = pytest.mark.cuda
TOL_AB = 5e-5
TOL_GN = 5e-3
TOL_LM = 8e-3


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def pose_max(a, b) -> float:
    return float((a - b).double().abs().max())


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["sphere10x10", "garage"])
def graph(dev, request):
    data = (datasets.sphere(n_rings=10, poses_per_ring=10, seed=1)
            if request.param == "sphere10x10" else datasets.garage())
    return from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)


def _ranks(g, p0, huber=-1.0):
    N = p0.shape[0]
    pk = g6.pack_graph6(g, N)
    K = pcr_levels_for(N, None)
    half = pk.El // 2
    return [cs6.make_shard6(pk, 0, half, K, 1.0, huber),
            cs6.make_shard6(pk, half, pk.El, K, 0.0, huber)]


def test_problem_struct_matches_the_c_side(dev):
    assert cs._lib("cg_step6", "cg6").cg6_problem_size() == ctypes.sizeof(cs._Problem)


@pytest.mark.parametrize("huber", [-1.0, 1.0])
def test_stage_a6_matches_twin(graph, huber):
    g, p0 = graph
    for sh in _ranks(g, p0, huber):
        payload, Aij = cs6.CgStep6Kernel(sh).stage_a(p0)
        ref, Aref = cs6.stage_a6_reference(sh, p0)
        torch.cuda.synchronize()
        for a, b in zip(cs6.unpack_payload6(payload, sh.N), cs6.unpack_payload6(ref, sh.N)):
            if sh.w_chain or b.abs().max() > 0:
                assert rel_err(a, b) <= TOL_AB
        assert rel_err(Aij, Aref) <= TOL_AB


def test_gn_setup6_and_cg_step6_match_twin(graph):
    g, p0 = graph
    shs = _ranks(g, p0)
    kerns = [sh.kernel() for sh in shs]
    got = [k.stage_a(p0) for k in kerns]
    refs = [cs6.stage_a6_reference(sh, p0) for sh in shs]
    reduced = got[0][0] + got[1][0]
    reduced_ref = refs[0][0] + refs[1][0]
    lam = torch.tensor([1e-3], device=p0.device)
    sts = [k.gn_setup(reduced.clone(), p0, lam) for k in kerns]
    srs = [cs6.gn_setup6_reference(sh, reduced_ref, p0, lam) for sh in shs]
    torch.cuda.synchronize()
    st, sr = sts[0], srs[0]
    assert rel_err(st.D, sr.D) <= TOL_AB and rel_err(st.b, sr.b) <= TOL_AB
    assert max(rel_err(st.A, sr.A), rel_err(st.G, sr.G), rel_err(st.Dinv, sr.Dinv)) <= 1e-4
    cks = [k.cg_state(sr.b) for k in kerns]
    crs = [cs6.cg_state(sr.b) for _ in shs]
    for it in range(26):
        for k, (_, A), ck in zip(kerns, got, cks):
            cs6.cg_step6(k.sh, k.setup, A, ck)
        for sh, s, (_, A), cr in zip(shs, srs, refs, crs):
            cs6.cg_step6_reference(sh, s, A, cr)
        for carry in (cks, crs):
            big = carry[0].big + carry[1].big
            for c in carry:
                c.big.copy_(big)
        if it in (0, 25):
            tol = 1e-4 if it == 0 else 1e-3
            for name in ("x", "r", "p", "cap", "big"):
                a, b = getattr(cks[0], name), getattr(crs[0], name)
                if b.abs().max() > 0:
                    assert rel_err(a, b) <= tol, (it, name)
            assert rel_err(cks[0].scal[:2], crs[0].scal[:2]) <= tol


def test_two_calls_bitwise_equal(graph):
    g, p0 = graph
    mesh = make_mesh()
    cfg = SolverConfig(cg_max_iterations=25)
    a = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3)
    b = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


def test_kernel_path_matches_plain_path(graph):
    g, p0 = graph
    mesh = make_mesh()
    cfg = SolverConfig(cg_max_iterations=25)
    n = cs6.cg_step6.launches
    a = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    assert cs6.cg_step6.launches - n == 3 * 26
    b = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=False)
    assert pose_max(a, b) <= TOL_GN
    lm_cfg = SolverConfig(cg_max_iterations=25, use_huber_on_loops=True)
    a, sa = dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=True)
    b, sb = dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=False)
    assert pose_max(a, b) <= TOL_LM and int(sa[2]) == int(sb[2])


def test_chain_only_graph(dev):
    data = datasets.sphere(n_rings=4, poses_per_ring=10, seed=2)
    g = from_dataset(data, device=dev)
    g = g.replace(edge_mask=g.edge_mask & (torch.arange(g.num_edges, device=dev) < g.chain_prefix))
    p0 = torch.from_numpy(data["poses"]).to(dev)
    cfg = SolverConfig(cg_max_iterations=12, pcr_levels=3)
    mesh = make_mesh()
    a = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    b = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=False)
    assert torch.isfinite(a).all() and pose_max(a, b) <= TOL_GN


def test_cpu_tensors_are_refused(dev):
    data = datasets.sphere(n_rings=3, poses_per_ring=6, seed=1)
    g = from_dataset(data, device="cpu")
    pk = g6.pack_graph6(g, 18)
    with pytest.raises(ValueError, match="CUDA"):
        cs6.CgStep6Kernel(cs6.make_shard6(pk, 0, pk.El, 3, 1.0, -1.0))


def _k7_passes(g, p0, huber, staged, passes=26):
    """Two emulated ranks through K7a, K7b and `passes` K7c passes, the
    persistent kernels or the staged sequences; both ranks' Setups, then
    both ranks' carries after pass 1 and after the last."""
    kerns = [sh.kernel() for sh in _ranks(g, p0, huber)]
    pays = [k.stage_a(p0)[0].clone() for k in kerns]
    lam = torch.tensor([1e-3], device=p0.device)
    sts = [(k.gn_setup_staged if staged else k.gn_setup)(pays[0] + pays[1], p0, lam)
           for k in kerns]
    snaps = [[t.clone() for st in sts for t in st]]
    carries = [k.cg_state(sts[0].b) for k in kerns]
    for it in range(passes):
        for k, c in zip(kerns, carries):
            (k.cg_step_staged if staged else k.cg_step)(k.Aij, c)
        big = carries[0].big + carries[1].big
        for c in carries:
            c.big.copy_(big)
        if it in (0, passes - 1):
            snaps.append([t.clone() for c in carries for t in c])
    torch.cuda.synchronize()
    return snaps


@pytest.mark.parametrize("huber", [-1.0, 1.0])
def test_gn_setup6_and_cg_step6_persistent_equal_staged_bitwise(graph, huber):
    g, p0 = graph
    a = _k7_passes(g, p0, huber, staged=False)
    b = _k7_passes(g, p0, huber, staged=True)
    again = _k7_passes(g, p0, huber, staged=False)
    assert torch.isfinite(a[-1][0]).all() and a[-1][0].abs().max() > 0
    for sa, sb, sc in zip(a, b, again):
        for x, y, z in zip(sa, sb, sc):
            assert torch.equal(x, y) and torch.equal(x, z)


def test_gn_setup6_and_cg_step6_are_one_launch(graph):
    from torch.profiler import ProfilerActivity, profile

    g, p0 = graph
    sh = _ranks(g, p0)[0]
    kern = sh.kernel()
    payload, Aij = kern.stage_a(p0)
    lam = torch.zeros(1, device=p0.device)
    st = cs6.gn_setup6(sh, payload, p0, lam)
    carry = kern.cg_state(st.b)
    cs6.cg_step6(sh, st, Aij, carry)
    torch.cuda.synchronize()
    for name, call in (("cg6_gn_setup_wide", lambda: cs6.gn_setup6(sh, payload, p0, lam)),
                       ("cg6_step_wide", lambda: cs6.cg_step6(sh, st, Aij, carry))):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                call()
            torch.cuda.synchronize()
        # one persistent launch a call (cudaLaunchKernelExC; the staged
        # kernels launch through cudaLaunchKernel); the device's records,
        # where the profiler kept them, name the persistent kernel alone
        events = prof.key_averages()
        calls = {e.key: e.count for e in events
                 if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")}
        assert calls == {"cudaLaunchKernelExC": 3}, (name, calls)
        launches = {e.key: e.count for e in events if "Cg6Problem" in e.key}
        assert all(name in k for k in launches) and sum(launches.values()) <= 3, launches


@pytest.fixture(scope="module", params=["sphere2500", "garage"])
def full_graph(dev, request):
    data = getattr(datasets, request.param)()
    return from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)


@pytest.mark.parametrize("huber", [-1.0, 1.0])
def test_stage_a6_one_launch_equals_staged_bitwise(full_graph, huber):
    # K7a (one launch of cg6_stage_a_persistent) against cg6_stage_a_staged
    # on two ranks' fresh shards: both ranks' payloads and Aij stashes, and
    # a second call alike
    g, p0 = full_graph
    runs = []
    for staged in (False, True, False):
        kerns = [sh.kernel() for sh in _ranks(g, p0, huber)]
        runs.append([t.clone() for k in kerns
                     for t in (k.stage_a_staged if staged else k.stage_a)(p0)])
    torch.cuda.synchronize()
    assert torch.isfinite(runs[0][0]).all() and runs[0][0].abs().max() > 0
    for x, y, z in zip(*runs):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_stage_a6_is_one_launch(full_graph):
    from torch.profiler import ProfilerActivity, profile

    g, p0 = full_graph
    sh = _ranks(g, p0)[0]
    kern = sh.kernel()
    N, rows = sh.N, max(sh.N, sh.c + sh.El)
    kern.lib.cg6_row_ctas.argtypes = [ctypes.c_longlong]
    assert kern.lib.cg6_row_ctas(rows) != 0
    for fn, want in ((lambda: cs6.stage_a6(sh, p0), {"cudaLaunchKernelExC": 3}),
                     (lambda: kern.stage_a_staged(p0), {"cudaLaunchKernel": 6})):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        calls = {e.key: e.count for e in prof.key_averages()
                 if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")}
        assert calls == want, (N, calls)
