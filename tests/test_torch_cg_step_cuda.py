"""K6a-c (csrc/cg_step.cu) against their plain torch twins on the card.

Needs an NVIDIA GPU and nvcc; without a card every case skips. The file
imports no JAX, so it also runs where JAX is not installed:
    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cg_step_cuda.py
Two ranks are emulated in one process: each holds half the loop edges, rank
0 the chain (w_chain 1), rank 1 none (w_chain 0), and the all-reduces are
sums of the two ranks' buffers. Tolerances (float32 on both sides; the
kernels sum in another order and use FMAs): the payload, Aij, D and b rel
5e-5 (under Huber at m3500 the angle wrap alone, rounded once as an FMA
rounds it, moves g by 8.7e-6 of its largest entry; 1.67e-5 was measured on
an H100); the PCR factor rel 1e-4 (K levels of 3x3 products and inverses);
the CG state after one pass rel 1e-4 (a PCR apply), after 26 passes rel
1e-3; the kernel path of dist_fused_gn_solve against the plain path on the
card wrapped atol 2e-4 on manhattan(260) (tests/test_dist_fused.py:170) and
2e-3 on m3500 from its drifted start (the repo's GN kernel tolerance;
2.8e-4 measured after 3 iterations). K6a, K6b and K6c are each one launch
of a persistent kernel on a thread-block cluster; each is held bitwise
(torch.equal) to the staged sequence it replaced (`stage_a_staged`,
`gn_setup_staged`, `cg_step_staged`), and to a second call, up to
city10000 (10000 poses: each of the 16 CTAs walks several row blocks).
"""

import ctypes
import math

import pytest
import torch

from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import from_dataset
from graphslam_tpu_torch.io import datasets
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.parallel import cg_step as cs
from graphslam_tpu_torch.parallel import dist_fused_gn_solve, dist_fused_lm_solve, make_mesh

pytestmark = pytest.mark.cuda
TOL_AB = 5e-5


def wrapped_max(a, b) -> float:
    d = (a - b).double()
    d[:, 2] = torch.remainder(d[:, 2] + math.pi, 2 * math.pi) - math.pi
    return float(d.abs().max())


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernel has no CPU mode")
    return torch.device("cuda")


@pytest.fixture(scope="module", params=["manhattan260", "m3500"])
def graph(dev, request):
    data = (datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)
            if request.param == "manhattan260" else datasets.m3500())
    return from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)


def _ranks(g, p0, huber=-1.0):
    N = p0.shape[0]
    pk = gk.pack_graph(g, N)
    K = 4
    half = pk.El // 2
    return [cs.make_shard(pk, 0, half, K, 1.0, huber),
            cs.make_shard(pk, half, pk.El, K, 0.0, huber)]


def test_problem_struct_matches_the_c_side(dev):
    assert cs._lib().cg_problem_size() == ctypes.sizeof(cs._Problem)


@pytest.mark.parametrize("huber", [-1.0, 1.0])
def test_stage_a_matches_twin(graph, huber):
    g, p0 = graph
    for sh in _ranks(g, p0, huber):
        payload, Aij = cs.CgStepKernel(sh).stage_a(p0)
        ref, Aref = cs.stage_a_reference(sh, p0)
        torch.cuda.synchronize()
        for a, b in zip(cs.unpack_payload(payload, sh.N), cs.unpack_payload(ref, sh.N)):
            if sh.w_chain or b.abs().max() > 0:
                assert rel_err(a, b) <= TOL_AB
        assert rel_err(Aij, Aref) <= TOL_AB


def test_gn_setup_and_cg_step_match_twin(graph):
    g, p0 = graph
    shs = _ranks(g, p0)
    kerns = [sh.kernel() for sh in shs]
    got = [k.stage_a(p0) for k in kerns]
    refs = [cs.stage_a_reference(sh, p0) for sh in shs]
    reduced = got[0][0] + got[1][0]
    reduced_ref = refs[0][0] + refs[1][0]
    lam = torch.tensor([1e-3], device=p0.device)
    sts = [k.gn_setup(reduced.clone(), p0, lam) for k in kerns]
    srs = [cs.gn_setup_reference(sh, reduced_ref, p0, lam) for sh in shs]
    torch.cuda.synchronize()
    st, sr = sts[0], srs[0]
    assert rel_err(st.D, sr.D) <= TOL_AB and rel_err(st.b, sr.b) <= TOL_AB
    assert max(rel_err(st.A, sr.A), rel_err(st.G, sr.G), rel_err(st.Dinv, sr.Dinv)) <= 1e-4
    cks = [k.cg_state(sr.b) for k in kerns]
    crs = [cs.cg_state(sr.b) for _ in shs]
    for it in range(26):
        for k, (_, A), ck in zip(kerns, got, cks):
            cs.cg_step(k.sh, k.setup, A, ck)
        for sh, s, (_, A), cr in zip(shs, srs, refs, crs):
            cs.cg_step_reference(sh, s, A, cr)
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
    cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4)
    a = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=3)
    b = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=3)
    torch.cuda.synchronize()
    assert torch.equal(a, b)


@pytest.fixture(scope="module")
def graph_tol(graph):
    return graph, 2e-4 if graph[1].shape[0] < 1000 else 2e-3


def test_kernel_path_matches_plain_path(graph_tol):
    (g, p0), tol = graph_tol
    mesh = make_mesh()
    cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4)
    n = cs.cg_step.launches
    a = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    assert cs.cg_step.launches - n == 3 * 26
    b = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=False)
    assert wrapped_max(a, b) <= tol
    lm_cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4, use_huber_on_loops=True)
    a, sa = dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=True)
    b, sb = dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=False)
    assert wrapped_max(a, b) <= 3e-3 and int(sa[2]) == int(sb[2])


def test_chain_only_graph(dev):
    data = datasets.manhattan(n_poses=120, seed=2, loop_prob=0.0)
    g = from_dataset(data, device=dev)
    p0 = torch.from_numpy(data["poses"]).to(dev)
    assert g.num_edges == g.chain_prefix
    cfg = SolverConfig(cg_max_iterations=12, pcr_levels=3)
    mesh = make_mesh()
    a = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    b = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=False)
    assert torch.isfinite(a).all() and wrapped_max(a, b) <= 2e-4


def test_cpu_tensors_are_refused(dev):
    data = datasets.manhattan(n_poses=40, loop_prob=0.25, seed=0)
    g = from_dataset(data, device="cpu")
    pk = gk.pack_graph(g, 40)
    with pytest.raises(ValueError, match="CUDA"):
        cs.CgStepKernel(cs.make_shard(pk, 0, pk.El, 3, 1.0, -1.0))


def _k6c_graph(graph, name):
    g, p0 = graph
    c, dev = g.chain_prefix, p0.device
    if name == "city10000":
        data = datasets.city10000()
        return from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)
    if name == "chain_only":
        return g.replace(edge_mask=g.edge_mask & (torch.arange(g.num_edges, device=dev) < c)), p0
    if name == "masked":
        mask = g.edge_mask.clone()
        mask[c::2] = False
        return g.replace(edge_mask=mask), p0
    return g, p0


def _k6c_passes(g, p0, huber, staged, passes=26):
    """Two emulated ranks through K6a, K6b and `passes` K6c passes, the
    persistent kernel or the staged sequence; rank 0's carry after pass 1
    and after the last."""
    kerns = [sh.kernel() for sh in _ranks(g, p0, huber)]
    pays = [k.stage_a(p0)[0].clone() for k in kerns]
    lam = torch.tensor([1e-3], device=p0.device)
    sts = [k.gn_setup(pays[0] + pays[1], p0, lam) for k in kerns]
    carries = [k.cg_state(sts[0].b) for k in kerns]
    snaps = []
    for it in range(passes):
        for k, c in zip(kerns, carries):
            (k.cg_step_staged if staged else k.cg_step)(k.Aij, c)
        big = carries[0].big + carries[1].big
        for c in carries:
            c.big.copy_(big)
        if it in (0, passes - 1):
            snaps.append([t.clone() for t in carries[0]])
    torch.cuda.synchronize()
    return snaps


@pytest.mark.parametrize("name,huber", [("plain", -1.0), ("plain", 1.0), ("masked", 1.0),
                                        ("chain_only", -1.0), ("city10000", 1.0)])
def test_cg_step_persistent_equals_staged_bitwise(graph, name, huber):
    g, p0 = _k6c_graph(graph, name)
    a = _k6c_passes(g, p0, huber, staged=False)
    b = _k6c_passes(g, p0, huber, staged=True)
    again = _k6c_passes(g, p0, huber, staged=False)
    assert torch.isfinite(a[-1][0]).all() and a[-1][0].abs().max() > 0
    for sa, sb, sc in zip(a, b, again):
        for x, y, z in zip(sa, sb, sc):
            assert torch.equal(x, y) and torch.equal(x, z)


def test_cg_step_is_one_launch(graph):
    from torch.profiler import ProfilerActivity, profile

    g, p0 = graph
    sh = _ranks(g, p0)[0]
    kern = sh.kernel()
    payload, Aij = kern.stage_a(p0)
    st = kern.gn_setup(payload, p0, torch.zeros(1, device=p0.device))
    carry = kern.cg_state(st.b)
    cs.cg_step(sh, st, Aij, carry)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            cs.cg_step(sh, st, Aij, carry)
        torch.cuda.synchronize()
    # one cluster launch a pass (cudaLaunchKernelExC; the staged kernels
    # launch through cudaLaunchKernel); the device's records, where the
    # profiler kept them (it kept none of a session in a process that ran
    # several other test files first), name the persistent kernel alone
    events = prof.key_averages()
    calls = {e.key: e.count for e in events if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")}
    assert calls == {"cudaLaunchKernelExC": 3}, calls
    launches = {e.key: e.count for e in events if "CgProblem" in e.key}
    assert all("cg_step_persistent" in k for k in launches) and sum(launches.values()) <= 3, launches


def test_foreign_carry_is_refused(graph):
    g, p0 = graph
    shs = _ranks(g, p0)
    kerns = [sh.kernel() for sh in shs]
    st = kerns[0].gn_setup(kerns[0].stage_a(p0)[0], p0, torch.zeros(1, device=p0.device))
    own = kerns[0].cg_state(st.b)
    other = kerns[1].cg_state(st.b)
    for bad in (cs.cg_state(st.b), other, own._replace(r=own.r.clone())):
        with pytest.raises(ValueError, match="carry"):
            cs.cg_step(shs[0], st, kerns[0].Aij, bad)
    stale = own
    kerns[0].cg_state(st.b)  # a new solve's carry replaces it
    with pytest.raises(ValueError, match="carry"):
        cs.cg_step(shs[0], st, kerns[0].Aij, stale)


def _k6ab(g, p0, name, huber, lam, staged):
    """Two emulated ranks through K6a and K6b (the payloads summed): the
    persistent entries or their staged sequences; every output of both
    ranks. name "chain_rank": rank 0 holds the chain and no loop edge."""
    pk = gk.pack_graph(g, p0.shape[0])
    cut = 0 if name == "chain_rank" else pk.El // 2
    kerns = [cs.make_shard(pk, 0, cut, 4, 1.0, huber).kernel(),
             cs.make_shard(pk, cut, pk.El, 4, 0.0, huber).kernel()]
    outs = [[t.clone() for t in (k.stage_a_staged if staged else k.stage_a)(p0)] for k in kerns]
    reduced = outs[0][0] + outs[1][0]
    lam_t = torch.tensor([lam], device=p0.device)
    outs += [[t.clone() for t in (k.gn_setup_staged if staged else k.gn_setup)(reduced, p0, lam_t)]
             for k in kerns]
    torch.cuda.synchronize()
    return [t for o in outs for t in o]


@pytest.mark.parametrize("name,huber,lam", [("plain", -1.0, 0.0), ("plain", 1.0, 1e-3),
                                            ("chain_rank", 1.0, 1e-3), ("city10000", 1.0, 1e-3)])
def test_stage_a_and_gn_setup_persistent_equal_staged_bitwise(graph, name, huber, lam):
    g, p0 = _k6c_graph(graph, name)
    a = _k6ab(g, p0, name, huber, lam, staged=False)
    b = _k6ab(g, p0, name, huber, lam, staged=True)
    again = _k6ab(g, p0, name, huber, lam, staged=False)
    dinv = a[8]  # rank 0's Dinv: both ranks' (payload, Aij), then rank 0's D, U, A, G, Dinv
    assert torch.isfinite(dinv).all() and dinv.abs().max() > 0
    for x, y, z in zip(a, b, again):
        assert torch.equal(x, y) and torch.equal(x, z)


def test_stage_a_and_gn_setup_are_one_launch_each(graph):
    from torch.profiler import ProfilerActivity, profile

    g, p0 = graph
    sh = _ranks(g, p0)[0]
    lam = torch.zeros(1, device=p0.device)
    payload, _ = cs.stage_a(sh, p0)
    cs.gn_setup(sh, payload, p0, lam)
    torch.cuda.synchronize()
    for fn in (lambda: cs.stage_a(sh, p0), lambda: cs.gn_setup(sh, payload, p0, lam)):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
        # one cluster launch a call (cudaLaunchKernelExC; the staged
        # kernels launch through cudaLaunchKernel)
        events = prof.key_averages()
        calls = {e.key: e.count for e in events
                 if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC")}
        assert calls == {"cudaLaunchKernelExC": 3}, calls
