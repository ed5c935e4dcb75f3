"""The port's SE(3) path against graphslam_tpu on the same numpy inputs.

Geometry (so3, se3), SE(3) linearize, chi2 and build_blocks, the 6x6
`_block_inv`, cyclic reduction with 6x6 blocks, chordal init, SE(3) ate/rpe
and the plain GN/LM loops (modes dense and pcg). Graphs are built in JAX
and carried over with from_numpy. Tolerances:
  * geometry in float32: atol 1e-5 (the same closed forms; only libm
    differs in the last ulps). Rotation vectors near pi are compared after
    both sides log the same float32 matrix, so the near-pi branch takes the
    same column on both.
  * the Jacobians (so3.left_jacobian_inv, se3._Q_matrix, the SE(3) inverse
    Jacobians) and linearize's whitened blocks in float64, atol 1e-9 and
    rtol/atol 1e-5: in float32 (1 - (t/2) cot(t/2))/t^2 cancels above
    t = 1e-6 and Q's closed forms cancel above 0.7 rad, and the whitening
    (x10 to x100) amplifies libm's last ulps there;
  * chi2 in float32: rtol 1e-5; 6x6 inverses: rtol 1e-5 against JAX and
    1e-4 against numpy; one cyclic-reduction solve: 1e-5 of the largest
    entry;
  * chordal init: atol 1e-3 (two rounds of 150-iteration CG in float32);
  * solver loops: poses within 5e-3 over the 12 pose entries for GN (the
    repo's SE(3) kernel-vs-XLA tolerance, tests/test_gn6_kernel.py:37),
    8e-3 for LM with Huber (:87), chi2 within 1%.
Time: ~40 s on one worker (my CPU run).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu import metrics as jmetrics
from graphslam_tpu.config import SolverConfig as JSolverConfig
from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.linearize import chi2 as jchi2
from graphslam_tpu.factors.linearize import linearize as jlinearize
from graphslam_tpu.factors.linearize import residuals as jresiduals
from graphslam_tpu.geometry import se3 as jse3
from graphslam_tpu.geometry import so3 as jso3
from graphslam_tpu.io import datasets
from graphslam_tpu.solver import lm as jlm
from graphslam_tpu.solver import normal_eq as jne
from graphslam_tpu.solver import tridiag as jtri
from graphslam_tpu.solver.init import chordal_init_se3 as jchordal_init_se3
from graphslam_tpu_torch import metrics
from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import chi2
from graphslam_tpu_torch.factors.linearize import group_for, linearize, residuals
from graphslam_tpu_torch.geometry import se3, so3
from graphslam_tpu_torch.solver import lm
from graphslam_tpu_torch.solver import normal_eq as ne
from graphslam_tpu_torch.solver import tridiag
from graphslam_tpu_torch.solver.init import chordal_init_se3

from _torch_port import carry, se3_max

ATOL = 1e-5
# |theta| at and around every series switch: 1e-6 (exp, Jacobians), 0.7 (Q)
MAGNITUDES = [0.0, 3e-7, 9e-7, 2e-6, 1e-3, 0.5, 0.69, 0.71, 2.0, 3.0, math.pi - 1e-3]


def _tangents(n_per=6, seed=0):
    """Rotation vectors with each magnitude of MAGNITUDES on random axes."""
    rng = np.random.default_rng(seed)
    axes = rng.normal(size=(len(MAGNITUDES) * n_per, 3))
    axes /= np.linalg.norm(axes, axis=1, keepdims=True)
    return axes * np.repeat(MAGNITUDES, n_per)[:, None]


def _near_pi_rotations():
    """Rotations with cos(theta) < -0.99 (the near-pi log branch), among them
    rotations about (1,1,0)/sqrt2 and (0,1,1)/sqrt2, whose columns of R + I
    tie in norm exactly: the first maximum must win on both sides."""
    rng = np.random.default_rng(1)
    axes = rng.normal(size=(24, 3))
    axes = list(axes / np.linalg.norm(axes, axis=1, keepdims=True))
    axes += [np.array([1.0, 1.0, 0.0]) / math.sqrt(2), np.array([0.0, 1.0, 1.0]) / math.sqrt(2)]
    out = []
    for a in axes:
        for th in (3.02, 3.1, math.pi - 1e-4):
            K = np.array([[0, -a[2], a[1]], [a[2], 0, -a[0]], [-a[1], a[0], 0]])
            out.append(np.eye(3) + math.sin(th) * K + (1 - math.cos(th)) * K @ K)
    return np.asarray(out)


def _cmp(ours, ref, atol=ATOL):
    a = ours.detach().numpy().astype(np.float64)
    b = np.asarray(ref, np.float64)
    assert a.shape == b.shape, (a.shape, b.shape)
    assert np.abs(a - b).max() <= atol, np.abs(a - b).max()


def _both(x, dtype):
    return torch.from_numpy(np.asarray(x, dtype)), jnp.asarray(np.asarray(x, dtype))


def test_so3_matches_jax():
    w_t, w_j = _both(_tangents(), np.float32)
    _cmp(so3.hat(w_t), jso3.hat(w_j))
    _cmp(so3.vee(so3.hat(w_t)), jso3.vee(jso3.hat(w_j)))
    _cmp(so3.exp(w_t), jso3.exp(w_j))
    _cmp(so3.left_jacobian(w_t), jso3.left_jacobian(w_j))
    R = np.array(jso3.exp(w_j))  # one float32 matrix for both logs
    _cmp(so3.log(torch.from_numpy(R)), jso3.log(jnp.asarray(R)))
    Rp = _near_pi_rotations().astype(np.float32)
    c = (np.trace(Rp, axis1=-2, axis2=-1) - 1) / 2
    assert (c < -0.99).all()
    _cmp(so3.log(torch.from_numpy(Rp)), jso3.log(jnp.asarray(Rp)))
    noisy = R + 1e-3 * np.random.default_rng(2).normal(size=R.shape).astype(np.float32)
    _cmp(so3.normalize(torch.from_numpy(noisy)), jso3.normalize(jnp.asarray(noisy)))
    M = np.random.default_rng(3).normal(size=(32, 3, 3)).astype(np.float32)
    _cmp(so3.project(torch.from_numpy(M)), jso3.project(jnp.asarray(M)), 1e-4)


def test_so3_log_inverts_exp_and_stays_in_its_branches():
    """float64 round trip. Near pi the reference's log takes the axis from a
    column of R + I, which is off by O(pi - theta): 1e-3 there."""
    w = torch.from_numpy(_tangents(seed=4))
    back = so3.log(so3.exp(w))
    near_pi = w.norm(dim=-1) > 3.05
    assert torch.allclose(back[~near_pi], w[~near_pi], atol=1e-9)
    assert torch.allclose(back[near_pi], w[near_pi], atol=5e-3)
    assert (back.norm(dim=-1) <= math.pi + 1e-12).all()


def test_jacobians_match_jax_in_float64():
    with jax.enable_x64(True):
        w_t, w_j = _both(_tangents(seed=5), np.float64)
        _cmp(so3.left_jacobian_inv(w_t), jso3.left_jacobian_inv(w_j), 1e-9)
        rho = np.random.default_rng(6).normal(scale=2.0, size=w_t.shape)
        r_t, r_j = _both(rho, np.float64)
        _cmp(se3._Q_matrix(r_t, w_t), jse3._Q_matrix(r_j, w_j), 1e-9)
        xi_t, xi_j = torch.cat([r_t, w_t], -1), jnp.concatenate([r_j, w_j], -1)
        _cmp(se3.left_jacobian_inv(xi_t), jse3.left_jacobian_inv(xi_j), 1e-9)
        _cmp(se3.right_jacobian_inv(xi_t), jse3.right_jacobian_inv(xi_j), 1e-9)
    # float32 at the 1e-5 geometry tolerance where nothing cancels
    xi = np.concatenate([rho, _tangents(seed=5)], -1)
    keep = np.abs(np.linalg.norm(xi[:, 3:], axis=1) - 0.7) > 0.05
    x_t, x_j = _both(xi[keep], np.float32)
    _cmp(se3.right_jacobian_inv(x_t), jse3.right_jacobian_inv(x_j), 1e-4)


def _se3_poses(n=64, seed=7):
    rng = np.random.default_rng(seed)
    w = _tangents(seed=seed)[:n]
    R = np.array(jso3.exp(jnp.asarray(w, jnp.float32)))
    t = rng.normal(scale=3.0, size=(len(R), 3)).astype(np.float32)
    return np.concatenate([R.reshape(-1, 9), t], -1)


def test_se3_matches_jax():
    a_t, a_j = _both(_se3_poses(seed=7), np.float32)
    b_t, b_j = _both(_se3_poses(seed=8), np.float32)
    _cmp(se3.compose(a_t, b_t), jse3.compose(a_j, b_j))
    _cmp(se3.inverse(a_t), jse3.inverse(a_j))
    _cmp(se3.between(a_t, b_t), jse3.between(a_j, b_j))
    _cmp(se3.adjoint(a_t), jse3.adjoint(a_j))
    _cmp(se3.renormalize(a_t), jse3.renormalize(a_j))
    pts = np.random.default_rng(9).normal(size=(len(a_t), 5, 3)).astype(np.float32)
    _cmp(se3.transform(a_t, torch.from_numpy(pts)), jse3.transform(a_j, jnp.asarray(pts)), 1e-4)
    rho = np.random.default_rng(10).normal(size=(len(MAGNITUDES) * 6, 3))
    xi_t, xi_j = _both(np.concatenate([rho, _tangents(seed=11)], -1), np.float32)
    _cmp(se3.exp(xi_t), jse3.exp(xi_j))
    _cmp(se3.retract(a_t, xi_t[: len(a_t)]), jse3.retract(a_j, xi_j[: len(a_j)]), 1e-4)
    p = np.array(jse3.exp(xi_j))  # one float32 pose for both logs
    _cmp(se3.log(torch.from_numpy(p)), jse3.log(jnp.asarray(p)), 1e-4)
    assert torch.allclose(se3.identity((2,)), torch.from_numpy(np.array(jse3.identity((2,)))))


@pytest.fixture(scope="module")
def small():
    """sphere(4, 6): 24 poses, 23 chain and 18 loop edges."""
    data = datasets.sphere(n_rings=4, poses_per_ring=6, seed=1)
    jg = jfrom_dataset(data)
    return jg, carry(jg), data


def test_group_for_and_carry_at_t6(small):
    jg, tg, data = small
    assert group_for(6) is se3 and tg.tangent_dim == 6 and tg.pose_dim == 12
    assert tg.chain_prefix == jg.chain_prefix
    np.testing.assert_array_equal(tg.sqrt_info.numpy(), np.asarray(jg.sqrt_info))
    with pytest.raises(ValueError, match="tangent dimension"):
        group_for(4)


@pytest.mark.parametrize("huber", [False, True])
def test_linearize_chi2_and_blocks_match_jax(small, huber):
    jg, _, data = small
    kw = dict(huber_delta=1.0, use_huber=huber)
    with jax.enable_x64(True):
        jg64 = jfrom_dataset(data, dtype=jnp.float64)
        tg64 = carry(jg64)
        p = np.asarray(data["poses"], np.float64)

        @jax.jit
        def jax_side(x):
            jl = jlinearize(x, jg64, **kw)
            return jl, jne.build_blocks(jl, jg64, p.shape[0]), jresiduals(x, jg64)

        jlin, jsys, jres = jax_side(jnp.asarray(p))
    lin = linearize(torch.from_numpy(p), tg64, **kw)
    for a, b in zip(lin, jlin):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    sysm = ne.build_blocks(lin, tg64, p.shape[0])
    for a, b in zip(sysm, jsys):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(residuals(torch.from_numpy(p), tg64).numpy(), np.asarray(jres),
                               rtol=1e-5, atol=1e-5)
    p32 = data["poses"].astype(np.float32)
    c = float(chi2(torch.from_numpy(p32), small[1], **kw))
    cj = float(jchi2(jnp.asarray(p32), jg, **kw))
    assert abs(c - cj) <= 1e-5 * cj


def test_block_inv_6x6_matches_jax_and_numpy():
    M = np.random.default_rng(12).normal(size=(64, 6, 6))
    spd = (M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(6)).astype(np.float32)
    ours = ne._block_inv(torch.from_numpy(spd)).numpy()
    ref = np.asarray(jne._block_inv(jnp.asarray(spd)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5 * np.abs(ref).max())
    np.testing.assert_allclose(ours, np.linalg.inv(spd.astype(np.float64)), rtol=1e-4, atol=1e-4)
    # other block sizes through the Cholesky factor
    M4 = M[:, :4, :4] @ np.swapaxes(M[:, :4, :4], -1, -2) + 0.5 * np.eye(4)
    np.testing.assert_allclose(ne._block_inv(torch.from_numpy(M4)).numpy(), np.linalg.inv(M4),
                               rtol=1e-6, atol=1e-6)


def _tridiag6(n=200, seed=13):
    rng = np.random.default_rng(seed)
    U = (0.3 * rng.normal(size=(n - 1, 6, 6))).astype(np.float32)
    A = rng.normal(size=(n, 6, 6))
    D = (A @ np.swapaxes(A, -1, -2) + 6.0 * np.eye(6)).astype(np.float32)
    return D, U, rng.normal(size=(n, 6)).astype(np.float32)


def test_cyclic_reduction_6x6_matches_jax_and_dense():
    D, U, b = _tridiag6()
    fac = tridiag.cr_factor(torch.from_numpy(D), torch.from_numpy(U))
    x = tridiag.cr_solve(fac, torch.from_numpy(b)).numpy()
    jx = np.asarray(jax.jit(lambda D, U, b: jtri.cr_solve(jtri.cr_factor(D, U), b))(
        jnp.asarray(D), jnp.asarray(U), jnp.asarray(b)))
    assert np.abs(x - jx).max() <= 1e-5 * np.abs(jx).max()
    n = D.shape[0]
    H = np.zeros((n * 6, n * 6))
    for i in range(n):
        H[6 * i:6 * i + 6, 6 * i:6 * i + 6] = D[i]
        if i + 1 < n:
            H[6 * i:6 * i + 6, 6 * i + 6:6 * i + 12] = U[i]
            H[6 * i + 6:6 * i + 12, 6 * i:6 * i + 6] = U[i].T
    exact = np.linalg.solve(H, b.reshape(-1).astype(np.float64)).reshape(n, 6)
    # the per-level ridge eps |tr|/T makes CR a preconditioner, not an exact solve
    assert np.abs(x - exact).max() <= 5e-2 * np.abs(exact).max()
    edges = torch.tensor([[i, i + 1] for i in range(n - 1)] + [[0, 5]], dtype=torch.int32)
    Aij = torch.cat([torch.from_numpy(U), torch.ones(1, 6, 6)])
    assert torch.equal(tridiag.chain_offdiag(edges, Aij, n), torch.from_numpy(U))


def test_chordal_init_se3_and_auto_init_match_jax():
    """Odometry with heavy rotation noise: the start is hopeless, and
    auto_init takes the chordal bootstrap on both sides."""
    data = datasets.sphere(n_rings=5, poses_per_ring=8, seed=2, rot_sigma=0.2)
    jg = jfrom_dataset(data)
    tg = carry(jg)
    n = data["poses"].shape[0]
    ref = np.asarray(jchordal_init_se3(jg, n))
    out = chordal_init_se3(tg, n)
    assert se3_max(out.numpy(), ref) <= 1e-3
    jauto = np.asarray(jlm.auto_init_poses(jnp.asarray(data["poses"]), jg))
    auto = lm.auto_init_poses(torch.from_numpy(data["poses"]), tg)
    assert not np.array_equal(jauto, data["poses"])  # JAX took the bootstrap
    assert torch.equal(auto, out)


def test_se3_ate_and_rpe_match_jax(small):
    _, _, data = small
    p, gt = data["poses"], data["gt"]
    for f, jf in ((metrics.ate, jmetrics.ate), (metrics.rpe, jmetrics.rpe)):
        a = float(f(torch.from_numpy(p), torch.from_numpy(gt)))
        b = float(jf(jnp.asarray(p), jnp.asarray(gt)))
        assert abs(a - b) <= 1e-5 * max(b, 1.0), (f.__name__, a, b)
    assert float(metrics.ate(torch.from_numpy(gt), torch.from_numpy(gt))) <= 1e-5


@pytest.mark.parametrize("mode", ["dense", "pcg"])
def test_gn_loop_matches_jax(small, mode):
    jg, tg, data = small
    kw = dict(mode=mode, cg_max_iterations=20, cg_tol=0.0)
    ref = np.asarray(jlm._gn_loop(jnp.asarray(data["poses"]), jg, JSolverConfig(**kw), mode, 3))
    out = lm._gn_loop(torch.from_numpy(data["poses"]), tg, SolverConfig(**kw), mode, 3)
    assert torch.isfinite(out).all()
    assert se3_max(out.numpy(), ref) <= 5e-3
    c, cj = float(chi2(out, tg)), float(jchi2(jnp.asarray(ref), jg))
    assert abs(c - cj) <= 1e-2 * cj
    # the retraction keeps rotations orthonormal
    R = se3.rot(out)
    assert torch.allclose(R @ R.transpose(-1, -2), torch.eye(3).expand_as(R), atol=1e-5)


@pytest.mark.parametrize("mode", ["dense", "pcg"])
def test_lm_loop_matches_jax(small, mode):
    jg, tg, data = small
    kw = dict(mode=mode, max_iterations=5, cg_max_iterations=25, use_huber_on_loops=True)
    ref = jlm._lm_loop(jnp.asarray(data["poses"]), jg, JSolverConfig(**kw), mode)
    out = lm.lm_solve(torch.from_numpy(data["poses"]), tg, SolverConfig(**kw))
    assert se3_max(out.poses.numpy(), ref.poses) <= 8e-3
    assert abs(float(out.error) - float(ref.error)) <= 1e-2 * float(ref.error)
    assert int(out.iterations) == int(ref.iterations)
    assert bool(out.converged) == bool(ref.converged)
