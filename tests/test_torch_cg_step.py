"""K6a-c's plain twins (graphslam_tpu_torch/parallel/cg_step.py) against the
JAX package's Pallas kernels themselves, in interpret mode.

One device, manhattan(150, seed 3, loop_prob 0.9) (30 loop edges in one
128-edge tile), pcr_levels 3, cg_iters 4: the smallest size with loop tiles.
Each check feeds both sides the same inputs: K6b takes the JAX K6a's
payload, K6c the JAX K6b's planes and factors and the JAX K6a's Aij stash.
The JAX kernels' packed (8, L) outputs are unpacked here, node n = s*L + l.
Tolerances are relative to the largest entry: 1e-5 for K6a and K6b, 2e-4
for K6c over cg_iters + 1 passes (f32 sums in another order, repeated).
The loop gathers run at hvp_splits = 3 on the JAX side, within f32
roundoff of exact; the port never rounds to bf16.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.factors import from_dataset as jax_from_dataset
from graphslam_tpu.io import datasets as jax_datasets
from graphslam_tpu.ops.gn_kernel import _pack_loop_edges
from graphslam_tpu.parallel import cg_step as jcg

from _torch_port import carry, once_per_session
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops.pcg_kernel import _shift_blocks, pcr_apply_reference
from graphslam_tpu_torch.parallel import cg_step as cs

N, NPAD, TILE, K, CG_ITERS = 150, 1024, 128, 3, 4
L, Q = NPAD // 8, NPAD // 128
TOL_AB = 1e-5
TOL_C = 2e-4


def _pack(x):
    R = x.shape[0]
    return x.reshape(R, 8, L).reshape(8 * R, L)


def _unpack(x, R):
    """(8R, L) packed rows -> (R, N) node-major."""
    return np.asarray(x).reshape(R, 8, L).reshape(R, NPAD)[:, :N]


def _rowmat(x):
    """(72, L) row-major 3x3 entries -> (N, 3, 3)."""
    return _unpack(x, 9).T.reshape(N, 3, 3)


def _planes(x):
    """(72, L) plane set, row block 3d + a = M[a, (a+d) % 3] -> (N, 3, 3)."""
    u = _unpack(x, 9)
    M = np.zeros((N, 3, 3), np.float32)
    for d in range(3):
        for a in range(3):
            M[:, a, (a + d) % 3] = u[3 * d + a]
    return M


def _vec(x):
    return _unpack(x, 3).T


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-30))


@pytest.fixture(scope="module")
def problem():
    data = jax_datasets.manhattan(n_poses=N, seed=3, loop_prob=0.9)
    jg = jax_from_dataset(data)
    dt = jnp.float32
    p = jnp.asarray(data["poses"])
    c = min(jg.chain_prefix, N - 1)
    cm = jg.edge_mask[:c].astype(dt)
    poses_pl = _pack(jnp.zeros((3, NPAD), dt).at[:, :N].set(p.T))
    cz = _pack(jnp.zeros((3, NPAD), dt).at[:, :c].set((jg.measurements[:c] * cm[:, None]).T))
    cR = _pack(jnp.zeros((9, NPAD), dt).at[:, :c].set(
        (jg.sqrt_info[:c] * cm[:, None, None]).reshape(c, 9).T))
    pz = _pack(jnp.zeros((NPAD, 3), dt).at[jg.prior_idx].set(jg.prior_meas).T)
    pR = _pack(jnp.zeros((NPAD, 3, 3), dt).at[jg.prior_idx].set(
        jg.prior_sqrt_info).reshape(NPAD, 9).T)
    eidx, eld, n_tiles = _pack_loop_edges(jg.edges, jg.measurements, jg.sqrt_info,
                                          jg.edge_mask, c, dt, TILE)
    assert n_tiles == 1
    jax_in = dict(poses=poses_pl, cz=cz, cR=cR, pz=pz, pR=pR, eidx=eidx, eld=eld,
                  nt=jnp.full((1, 1), n_tiles, jnp.int32), q0=jnp.zeros((2, n_tiles), jnp.int32))
    g = carry(jg)
    pk = gk.pack_graph(g, N)
    return jax_in, pk, torch.from_numpy(np.asarray(data["poses"]))


def _jax_stage_a(ji, w, huber):
    return jcg.stage_a(ji["poses"], ji["cz"], ji["cR"], ji["eidx"], ji["eld"], ji["nt"],
                       jnp.full((1, 1), w, jnp.float32), ji["q0"], Q=Q, L=L, tile=TILE,
                       tiles_per_dev=1, huber_delta=huber, win=0, interpret=True)


def _jax_gn_setup(ji, big, lam):
    """The JAX K6b's outputs at damping lam, as numpy."""
    outs = jcg.gn_setup(jnp.full((1, 1), lam, jnp.float32), big, ji["poses"], ji["pz"],
                        ji["pR"], N=N, K=K, Q=Q, L=L, eps=3e-4, interpret=True)
    return tuple(np.asarray(o) for o in outs)


_SHARED = {}


def _shared(name, compute, tmp_path_factory):
    """compute() once per process and, under xdist, once per session
    (tests/_torch_port.py::once_per_session): the interpret-mode JAX kernels
    that several tests of this file run on the same inputs."""
    if name not in _SHARED:
        _SHARED[name] = once_per_session(f"test_torch_cg_step_{name}", compute,
                                         tmp_path_factory)
    return _SHARED[name]


def _jax_k6a_rank0(ji, tmp_path_factory):
    """The JAX K6a of rank 0 without Huber: (big, aij) as numpy."""
    return _shared("k6a_rank0",
                   lambda: tuple(np.asarray(o) for o in _jax_stage_a(ji, 1.0, -1.0)),
                   tmp_path_factory)


def _jax_k6b_lam0(ji, big, tmp_path_factory):
    """The JAX K6b at lam 0 on rank 0's K6a payload."""
    return _shared("k6b_lam0", lambda: _jax_gn_setup(ji, big, 0.0), tmp_path_factory)


def _payload_of(big):
    """The JAX K6a output -> the port's payload: chain rows plus the loop
    accumulator, as JAX's gn_setup adds them."""
    big = np.asarray(big)
    dg = big[168:168 + 12 * Q * 128 // L].reshape(12, NPAD)[:, :N]
    D = _rowmat(big[:72]) + dg[:9].T.reshape(N, 3, 3)
    U = _rowmat(big[72:144])
    g = _vec(big[144:168]) + dg[9:].T
    return D, U, g


@pytest.mark.parametrize("w,huber", [(1.0, -1.0), (0.0, -1.0), (1.0, 1.0)],
                         ids=["rank0", "rank1", "huber"])
def test_stage_a_twin_matches_jax_kernel(problem, w, huber, tmp_path_factory):
    ji, pk, poses = problem
    if (w, huber) == (1.0, -1.0):
        big, aij = _jax_k6a_rank0(ji, tmp_path_factory)
    else:
        big, aij = _jax_stage_a(ji, w, huber)
    sh = cs.make_shard(pk, 0, pk.El, K, w, huber)
    payload, Aij = cs.stage_a_reference(sh, poses)
    for name, a, b in zip("DUg", cs.unpack_payload(payload, N), _payload_of(big)):
        if w == 0.0 and name == "U":
            assert not b.any() and not a.any()
            continue
        assert _rel(a, b) <= TOL_AB, name
    A_ref = np.asarray(aij)[:, :pk.El].T.reshape(pk.El, 3, 3)
    assert _rel(Aij, A_ref) <= TOL_AB


@pytest.fixture(scope="module")
def setup(problem, tmp_path_factory):
    """The JAX K6a of rank 0, and the port's Shard."""
    ji, pk, poses = problem
    big, aij = _jax_k6a_rank0(ji, tmp_path_factory)
    sh = cs.make_shard(pk, 0, pk.El, K, 1.0, -1.0)
    return ji, sh, poses, big, aij


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_gn_setup_twin_matches_jax_kernel(setup, lam, tmp_path_factory):
    ji, sh, poses, big, _ = setup
    outs = (_jax_k6b_lam0(ji, big, tmp_path_factory) if lam == 0.0
            else _jax_gn_setup(ji, big, lam))
    dpl, upl, lpl, afac, gfac, dinv, b24 = outs
    payload = torch.cat([torch.from_numpy(np.ascontiguousarray(t)).reshape(-1)
                         for t in _payload_of(big)])
    st = cs.gn_setup_reference(sh, payload, poses, torch.tensor([lam]))
    assert _rel(st.D, _planes(dpl)) <= TOL_AB
    assert _rel(st.U, _planes(upl)) <= TOL_AB
    assert _rel(_shift_blocks(st.U.transpose(-1, -2), 1), _planes(lpl)) <= TOL_AB
    for k in range(K):
        assert _rel(st.A[k], _planes(afac[72 * k: 72 * (k + 1)])) <= TOL_AB, k
        assert _rel(st.G[k], _planes(gfac[72 * k: 72 * (k + 1)])) <= TOL_AB, k
    assert _rel(st.Dinv, _planes(dinv)) <= TOL_AB
    assert _rel(st.b, _vec(b24)) <= TOL_AB


def test_cg_step_twin_matches_jax_kernel(setup, tmp_path_factory):
    ji, sh, poses, big, aij = setup
    dpl, upl, lpl, afac, gfac, dinv, b24 = _jax_k6b_lam0(ji, big, tmp_path_factory)
    to_t = lambda a: torch.from_numpy(np.ascontiguousarray(a))  # noqa: E731
    st = cs.Setup(D=to_t(_planes(dpl)), U=to_t(_planes(upl)),
                  A=torch.stack([to_t(_planes(np.asarray(afac)[72 * k: 72 * (k + 1)]))
                                 for k in range(K)]),
                  G=torch.stack([to_t(_planes(np.asarray(gfac)[72 * k: 72 * (k + 1)]))
                                 for k in range(K)]),
                  Dinv=to_t(_planes(dinv)), b=to_t(_vec(b24)))
    Aij = to_t(np.asarray(aij)[:, :sh.El].T.reshape(sh.El, 3, 3))
    z24 = jnp.zeros((24, L), jnp.float32)
    jst = (z24, b24, z24, z24, jnp.zeros((8, 128), jnp.float32),
           jnp.zeros((3 * Q + 8, 128), jnp.float32))
    carry_ = cs.cg_state(st.b)
    for it in range(CG_ITERS + 1):
        jst = jcg.cg_step(*jst, dpl, upl, lpl, afac, gfac, dinv, ji["eidx"], aij, ji["nt"],
                          ji["q0"], K=K, Q=Q, L=L, tile=TILE, tiles_per_dev=1, hvp_splits=3,
                          win=0, interpret=True)
        cs.cg_step_reference(sh, st, Aij, carry_)  # one rank: the all-reduce is identity
        tol = TOL_AB if it == 0 else TOL_C
        for name, a, b in zip(("x", "r", "p", "cap"), carry_[:4], jst[:4]):
            if it == 0 and name == "x":
                assert not carry_.x.any() and not np.asarray(b).any()
                continue
            assert _rel(a, _vec(b)) <= tol, (it, name)
        scal, part = np.asarray(jst[4]), np.asarray(jst[5])
        tile_ap = part[: 3 * Q].reshape(3, NPAD)[:, :N].T
        assert _rel(carry_.big[: 3 * N].view(N, 3), tile_ap) <= tol, it
        got = carry_.scal[:2].tolist() + [float(carry_.big[3 * N])]
        ref = [scal[0, 0], scal[0, 1], part[3 * Q, 0]]
        assert _rel(got, ref) <= tol, (it, got, ref)


def _roll_pcr_factor(D, U, K_):
    """PCR as the TPU kernel runs it: over NPAD rows with circular shifts
    (the packed roll), with the port's ridge and inverse."""
    roll = lambda X, s: torch.roll(X, s, 0)  # noqa: E731
    L_ = roll(U.transpose(-1, -2), 1)
    A_s, G_s = [], []
    for k in range(K_):
        h = 1 << k
        D = gk._ridge(D, gk._EPS)
        Dinv = gk._binv(D)
        alpha, gamma = gk._mm(L_, roll(Dinv, h)), gk._mm(U, roll(Dinv, -h))
        A_s.append(alpha)
        G_s.append(gamma)
        D = D - gk._mm(alpha, roll(U, h)) - gk._mm(gamma, roll(L_, -h))
        L_, U = -gk._mm(alpha, roll(L_, h)), -gk._mm(gamma, roll(U, -h))
    return torch.stack(A_s), torch.stack(G_s), gk._binv(gk._ridge(D, gk._EPS))


@pytest.mark.parametrize("levels", [3, 8])
def test_pcr_over_n_equals_pcr_over_padded_rows(setup, levels):
    """The TPU kernel runs PCR over NPAD rows, identity on the pad rows and
    a circular roll; the port over exactly N with zero fill. Rows >= N are
    decoupled (U is zero from c <= N-1 on), so the real rows agree exactly."""
    _, sh, poses, big, _ = setup
    payload = torch.cat([torch.from_numpy(np.ascontiguousarray(t)).reshape(-1)
                         for t in _payload_of(big)])
    st = cs.gn_setup_reference(sh, payload, poses, torch.tensor([0.0]))
    A, G, Dinv = gk.pcr_factor_reference(st.D, st.U, levels)
    Dp = torch.eye(3).repeat(NPAD, 1, 1)
    Dp[:N] = st.D
    Up = torch.zeros((NPAD, 3, 3))
    Up[:N] = st.U
    Ap, Gp, Dinvp = _roll_pcr_factor(Dp, Up, levels)
    assert torch.equal(Ap[:, :N], A) and torch.equal(Gp[:, :N], G)
    assert torch.equal(Dinvp[:N], Dinv)
    r = torch.randn((N, 3), generator=torch.Generator().manual_seed(0))
    rp = torch.zeros((NPAD, 3))
    rp[:N] = r
    zp = rp
    for k in range(levels):
        h = 1 << k
        zp = (zp - gk._mv(Ap[k], torch.roll(zp, h, 0))) - gk._mv(Gp[k], torch.roll(zp, -h, 0))
    zp = gk._mv(Dinvp, zp)
    assert torch.equal(zp[:N], pcr_apply_reference(A, G, Dinv, r))
