"""K7a-c's plain twins (graphslam_tpu_torch/parallel/cg_step6.py) against the
port's own plain stages, on the CPU.

The JAX package's `cg_step6` kernels have no test of their own and run for
minutes in interpret mode, so the twins are held to what the rest of the
port already holds to JAX (tests/test_torch_se3.py,
tests/test_torch_gn6_kernel.py): K7a's payload, summed over the ranks and
with the priors added, against system_reference6's blocks; K7b's factor
against pcr_factor_reference6; one K7c pass against the same pass written
out in float64 with a dense Hessian; cg_iters + 1 passes against the fused
kernel twin's CG (gn_kernel.cg_reference). Graph: sphere(6, 8, seed 1), 48
poses and 40 loop edges, exact PCR (K = 6). Tolerances, relative to the
largest entry: 2e-6 for the assembly and the factor (float32 sums in
another order), 1e-5 for one pass, 1e-4 after 13 passes (roundoff
repeated). PCR over exactly N nodes is bitwise equal, on the real rows, to
PCR as the TPU kernel runs it: over 1024 rows, identity on the pad rows,
circular shifts.
"""

import numpy as np
import pytest
import torch

from graphslam_tpu_torch.factors import from_dataset
from graphslam_tpu_torch.io import datasets
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops import gn6_kernel as g6
from graphslam_tpu_torch.ops.pcg_kernel import _shift_blocks, pcr_apply_reference
from graphslam_tpu_torch.parallel import cg_step6 as cs6

N, NPAD, K, CG_ITERS = 48, 1024, 6, 12
TOL_ASSEMBLY = 2e-6
TOL_PASS = 1e-5
TOL_CG = 1e-4


def _rel(a, b) -> float:
    a, b = torch.as_tensor(a, dtype=torch.float64), torch.as_tensor(b, dtype=torch.float64)
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


@pytest.fixture(scope="module")
def problem():
    data = datasets.sphere(n_rings=6, poses_per_ring=8, seed=1)
    g = from_dataset(data, device="cpu")
    p0 = torch.from_numpy(data["poses"])
    assert p0.shape[0] == N
    return g, g6.pack_graph6(g, N), p0


def _two_ranks(pk, huber):
    half = pk.El // 2
    return [cs6.make_shard6(pk, 0, half, K, 1.0, huber),
            cs6.make_shard6(pk, half, pk.El, K, 0.0, huber)]


@pytest.mark.parametrize("huber", [-1.0, 1.0], ids=["plain", "huber"])
def test_stage_a6_twin_matches_system_reference6(problem, huber):
    """Two ranks' payloads sum to the whole system's chain and loop blocks:
    rank 1 adds no chain (w_chain 0), the priors come in K7b."""
    _, pk, p0 = problem
    shs = _two_ranks(pk, huber)
    outs = [cs6.stage_a6_reference(sh, p0) for sh in shs]
    assert outs[0][0].shape == (cs6.payload_size6(N),) == (78 * N,)
    D, U, g = cs6.unpack_payload6(outs[0][0] + outs[1][0], N)
    Ap, gp = cs6.prior_blocks6(p0, shs[0])
    sysm = g6.system_reference6(p0, pk, huber)
    assert _rel(D + Ap, sysm.D) <= TOL_ASSEMBLY
    assert _rel(-(g + gp), sysm.b) <= TOL_ASSEMBLY
    assert torch.equal(U, sysm.U)
    assert not cs6.unpack_payload6(outs[1][0], N)[1].any()
    assert torch.equal(torch.cat([outs[0][1], outs[1][1]]), sysm.Aij_loop)


def test_masked_loop_edges_stay_out(problem):
    g, _, p0 = problem
    mask = g.edge_mask.clone()
    mask[g.chain_prefix::3] = False
    pk = g6.pack_graph6(g.replace(edge_mask=mask), N)
    sh = cs6.make_shard6(pk, 0, pk.El, K, 1.0, -1.0)
    assert int(sh.csr_ptr[-1]) == 2 * int(pk.loop_mask.sum()) < 2 * pk.El
    payload, _ = cs6.stage_a6_reference(sh, p0)
    D, _, g_ = cs6.unpack_payload6(payload, N)
    Ap, gp = cs6.prior_blocks6(p0, sh)
    sysm = g6.system_reference6(p0, pk)
    assert _rel(D + Ap, sysm.D) <= TOL_ASSEMBLY and _rel(-(g_ + gp), sysm.b) <= TOL_ASSEMBLY


@pytest.fixture(scope="module")
def setup(problem):
    """One rank holding every loop edge: its twins' Setup at lam 1e-3, and
    the system it factors."""
    _, pk, p0 = problem
    sh = cs6.make_shard6(pk, 0, pk.El, K, 1.0, -1.0)
    payload, Aij = cs6.stage_a6_reference(sh, p0)
    lam = torch.tensor([1e-3])
    st = cs6.gn_setup6_reference(sh, payload, p0, lam)
    return sh, st, Aij, g6.system_reference6(p0, pk, lam=lam[0]), pk


def test_gn_setup6_twin_matches_pcr_factor_reference6(setup):
    _, st, _, sysm, _ = setup
    assert _rel(st.D, sysm.D) <= TOL_ASSEMBLY and _rel(st.b, sysm.b) <= TOL_ASSEMBLY
    assert torch.equal(st.U, sysm.U)
    A, G, Dinv = g6.pcr_factor_reference6(sysm.D, sysm.U, K)
    assert st.A.shape == (K, N, 6, 6)
    for a, b in ((st.A, A), (st.G, G), (st.Dinv, Dinv)):
        assert _rel(a, b) <= TOL_ASSEMBLY


def _dense(sh, st, Aij):
    """(chain Hessian, this rank's loop Hessian) as dense (6N, 6N) float64."""
    Hc = torch.zeros((N, 6, N, 6), dtype=torch.float64)
    Hl = torch.zeros_like(Hc)
    for n in range(N):
        Hc[n, :, n] = st.D[n].double()
        if n + 1 < N:
            Hc[n, :, n + 1] = st.U[n].double()
            Hc[n + 1, :, n] = st.U[n].T.double()
    for l in range(sh.El):
        i, j = int(sh.loop_i[l]), int(sh.loop_j[l])
        Hl[i, :, j] += Aij[l].double()
        Hl[j, :, i] += Aij[l].T.double()
    return Hc.reshape(6 * N, 6 * N), Hl.reshape(6 * N, 6 * N)


def test_one_cg_step6_pass_matches_the_pass_written_out(setup):
    sh, st, Aij, _, _ = setup
    Hc, Hl = _dense(sh, st, Aij)
    rng = np.random.default_rng(3)
    x, r, p = (torch.from_numpy(rng.normal(size=(N, 6)).astype(np.float32)) for _ in range(3))
    pd = p.double().reshape(-1)
    cap, tile = (Hc @ pd).float().view(N, 6), (Hl @ pd).float().view(N, 6)
    rz = 2.5
    carry = cs6.cg_state(st.b)
    for t, v in ((carry.x, x), (carry.r, r), (carry.p, p), (carry.cap, cap)):
        t.copy_(v)
    carry.scal[:2] = torch.tensor([rz, float(p.reshape(-1) @ cap.reshape(-1))])
    carry.big[: 6 * N] = tile.reshape(-1)
    carry.big[6 * N] = float(p.reshape(-1) @ tile.reshape(-1))
    # the pass in float64: guarded alpha, x, r, the PCR apply, beta, p, H p
    s0, s1 = float(pd @ (Hc @ pd)), float(pd @ (Hl @ pd))
    alpha = rz / (s0 + s1)
    x_ref = x.double() + alpha * p.double()
    r_ref = r.double() - alpha * (cap.double() + tile.double())
    z = pcr_apply_reference(st.A.double(), st.G.double(), st.Dinv.double(), r_ref)
    rz_new = float((r_ref * z).sum())
    p_ref = z + (rz_new / rz) * p.double()
    cap_ref = (Hc @ p_ref.reshape(-1)).view(N, 6)
    tile_ref = (Hl @ p_ref.reshape(-1)).view(N, 6)
    cs6.cg_step6_reference(sh, st, Aij, carry)
    for a, b in ((carry.x, x_ref), (carry.r, r_ref), (carry.p, p_ref), (carry.cap, cap_ref),
                 (carry.big[: 6 * N].view(N, 6), tile_ref)):
        assert _rel(a, b) <= TOL_PASS
    got = [float(carry.scal[0]), float(carry.scal[1]), float(carry.big[6 * N])]
    ref = [rz_new, float((p_ref * cap_ref).sum()), float((p_ref * tile_ref).sum())]
    assert _rel(got, ref) <= TOL_PASS


def test_cg_passes_match_the_fused_twin_cg(setup):
    """cg_iters + 1 passes from the zero carry: the first is the prologue
    (alpha = beta = 0 exactly), the rest are the fused twin's CG iterations."""
    sh, st, Aij, sysm, pk = setup
    carry = cs6.cg_state(st.b)
    cs6.cg_step6_reference(sh, st, Aij, carry)
    assert not carry.x.any() and torch.equal(carry.r, st.b)
    assert torch.equal(carry.p, pcr_apply_reference(st.A, st.G, st.Dinv, st.b))
    for _ in range(CG_ITERS):
        cs6.cg_step6_reference(sh, st, Aij, carry)
    x = gk.cg_reference(sysm, pk, g6.pcr_factor_reference6(sysm.D, sysm.U, K), CG_ITERS)
    assert _rel(carry.x, x) <= TOL_CG


def _roll_pcr_factor6(D, U, K_):
    """PCR as the TPU kernel runs it: over NPAD rows with circular shifts
    (dist_fused6.py:100-117), with the port's ridge and 6x6 inverse."""
    roll = lambda X, s: torch.roll(X, s, 0)  # noqa: E731
    L_ = roll(U.transpose(-1, -2), 1)
    A_s, G_s = [], []
    for k in range(K_):
        h = 1 << k
        D = g6.ridge6(D, gk._EPS)
        Dinv = g6.binv6(D)
        alpha, gamma = g6._mm(L_, roll(Dinv, h)), g6._mm(U, roll(Dinv, -h))
        A_s.append(alpha)
        G_s.append(gamma)
        D = D - g6._mm(alpha, roll(U, h)) - g6._mm(gamma, roll(L_, -h))
        L_, U = -g6._mm(alpha, roll(L_, h)), -g6._mm(gamma, roll(U, -h))
    return torch.stack(A_s), torch.stack(G_s), g6.binv6(g6.ridge6(D, gk._EPS))


@pytest.mark.parametrize("levels", [3, K, 10])
def test_pcr_over_n_equals_pcr_over_padded_rows(setup, levels):
    """Rows >= N are decoupled (U is zero from c <= N-1 on, and L[0] rolls
    in a pad row's zero U), so the real rows agree exactly, at levels past
    N too (h = 512 reaches around the 1024 rows)."""
    _, st, _, _, _ = setup
    A, G, Dinv = g6.pcr_factor_reference6(st.D, st.U, levels)
    Dp = torch.eye(6).repeat(NPAD, 1, 1)
    Dp[:N] = st.D
    Up = torch.zeros((NPAD, 6, 6))
    Up[:N] = st.U
    Ap, Gp, Dinvp = _roll_pcr_factor6(Dp, Up, levels)
    assert torch.equal(Ap[:, :N], A) and torch.equal(Gp[:, :N], G)
    assert torch.equal(Dinvp[:N], Dinv)
    r = torch.randn((N, 6), generator=torch.Generator().manual_seed(0))
    zp = torch.zeros((NPAD, 6))
    zp[:N] = r
    for k in range(levels):
        h = 1 << k
        zp = (zp - g6._mv(Ap[k], torch.roll(zp, h, 0))) - g6._mv(Gp[k], torch.roll(zp, -h, 0))
    zp = g6._mv(Dinvp, zp)
    assert torch.equal(zp[:N], pcr_apply_reference(A, G, Dinv, r))
    assert torch.equal(_shift_blocks(st.U.transpose(-1, -2), 1)[0], torch.zeros(6, 6))
