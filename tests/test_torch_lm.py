"""Levenberg-Marquardt in the port (solver/lm.py, the fused LM kernel's twin,
solver/init.py) against graphslam_tpu on the CPU.

Graphs are built in JAX and carried over with from_numpy. The JAX fused LM
kernel runs in interpret mode, as tests/test_gn_kernel.py runs it.
Tolerances are the repo's LM/Huber ones (tests/test_gn_kernel.py): poses
within wrapped atol 3e-3, chi2 within 1%; accepted-step counts and the
convergence flags equal. Chordal init: atol 1e-3 (two linear solves of 150
CG iterations in float32). The repaired damping: rtol 1e-4 of the largest
entry (its blocks are sums in another order); the 2x2 inverse: 1e-6 (the
same float32 formula on both sides).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import SolverConfig as JSolverConfig
from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.linearize import chi2 as jchi2
from graphslam_tpu.factors.linearize import linearize as jlinearize
from graphslam_tpu.io import datasets
from graphslam_tpu.ops.gn_kernel import fused_lm_solve as jfused_lm_solve
from graphslam_tpu.solver import lm as jlm
from graphslam_tpu.solver import normal_eq as jne
from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import chi2
from graphslam_tpu_torch.factors.linearize import linearize
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.solver import lm
from graphslam_tpu_torch.solver import normal_eq as ne
from graphslam_tpu_torch.solver.init import chordal_init_se2

from _torch_port import carry, wrapped_max

POSE_ATOL = 3e-3
HUBER = dict(huber_delta=1.0, use_huber=True)


@pytest.fixture(scope="module")
def small():
    """manhattan(150) with 12 loop edges: JAX graph, port graph, poses."""
    data = datasets.manhattan(n_poses=150, loop_prob=0.5, seed=0)
    jg = jfrom_dataset(data)
    return jg, carry(jg), data["poses"]


def test_fused_lm_twin_matches_jax_kernel_interpret(small):
    jg, tg, p0 = small
    kw = dict(iterations=5, cg_iters=25, huber_delta=1.0, pcr_levels=4)
    ref = jfused_lm_solve(jnp.asarray(p0), jg, interpret=True, **kw)
    out = gk.fused_lm_solve(torch.from_numpy(p0), tg, **kw)
    assert all(t.shape == () for t in out[1:])
    assert wrapped_max(out[0].numpy(), ref[0]) <= POSE_ATOL
    assert abs(float(out[1]) - float(ref[1])) <= 1e-2 * float(ref[1])
    assert float(out[3]) == float(ref[3])
    assert float(out[4]) == float(ref[4])
    c, cj = float(chi2(out[0], tg, **HUBER)), float(jchi2(ref[0], jg, **HUBER))
    assert abs(c - cj) <= 1e-2 * cj
    # the kernel's cost is the XLA chi2 with Huber where every non-chain edge is a loop
    pk = gk.pack_graph(tg, p0.shape[0])
    assert abs(float(gk.chi2_reference(out[0], pk, 1.0)) - c) <= 1e-5 * c


@pytest.mark.parametrize("mode", ["dense", "pcg", "pcg_fused"])
def test_lm_loop_matches_jax(small, mode):
    jg, tg, p0 = small
    kw = dict(mode=mode, max_iterations=5, cg_max_iterations=25, use_huber_on_loops=True)
    ref = jlm._lm_loop(jnp.asarray(p0), jg, JSolverConfig(**kw), mode)
    out = lm._lm_loop(torch.from_numpy(p0), tg, SolverConfig(**kw), mode)
    assert torch.isfinite(out.poses).all()
    assert wrapped_max(out.poses.numpy(), ref.poses) <= POSE_ATOL
    assert abs(float(out.error) - float(ref.error)) <= 1e-2 * float(ref.error)
    assert int(out.iterations) == int(ref.iterations)
    assert bool(out.converged) == bool(ref.converged)


def test_gn_loop_pcg_fused_matches_jax(small):
    jg, tg, p0 = small
    kw = dict(mode="pcg_fused", cg_max_iterations=25)
    ref = jlm._gn_loop(jnp.asarray(p0), jg, JSolverConfig(**kw), "pcg_fused", 3)
    out = lm._gn_loop(torch.from_numpy(p0), tg, SolverConfig(**kw), "pcg_fused", 3)
    assert wrapped_max(out.numpy(), ref) <= 2e-3


def test_lm_solve_dispatch(small):
    """gn_fused: the fused LM kernel (twin on the CPU), iterations = accepted
    steps; other modes: _lm_loop, iterations = loop count, early exit."""
    jg, tg, p0 = small
    p = torch.from_numpy(p0)
    cfg = SolverConfig(mode="gn_fused", max_iterations=4, cg_max_iterations=20,
                       use_huber_on_loops=True, pcr_levels=4)
    st = lm.lm_solve(p, tg, cfg)
    poses, err, lam, n_acc, conv = gk.fused_lm_solve_reference(
        p, tg, iterations=4, cg_iters=20, huber_delta=1.0, pcr_levels=4)
    assert isinstance(st, lm.LMState)
    assert torch.equal(st.poses, poses) and torch.equal(st.error, err)
    assert st.iterations.dtype == torch.int32 and int(st.iterations) == int(n_acc)
    assert st.converged.dtype == torch.bool and bool(st.converged) == bool(conv)
    # _lm_loop's early exit: a loose relative tolerance converges at once
    cfg = SolverConfig(mode="pcg", max_iterations=30, cg_max_iterations=25, rel_decrease_tol=0.5)
    st = lm.lm_solve(p, tg, cfg)
    jst = jlm.lm_solve(jnp.asarray(p0), jg, JSolverConfig(mode="pcg", max_iterations=30,
                                                           cg_max_iterations=25,
                                                           rel_decrease_tol=0.5))
    assert bool(st.converged) and int(st.iterations) == int(jst.iterations) < 30
    assert torch.equal(lm.lm_solve(p, tg, cfg, auto_init=True).poses, st.poses)  # sane start


def test_lm_from_optimum_stays_finite(small):
    """The LM twin of test_warm_start_at_optimum_stays_finite: at the optimum
    the CG right-hand side is roundoff, pAp can reach <= 0, and the guard
    freezes the update; rejected steps keep the cost from rising."""
    jg, tg, p0 = small
    kw = dict(cg_iters=25, huber_delta=1.0)
    opt, err_opt, *_ = gk.fused_lm_solve(torch.from_numpy(p0), tg, iterations=8, **kw)
    again, err, lam, n_acc, conv = gk.fused_lm_solve(opt, tg, iterations=8, **kw)
    assert torch.isfinite(again).all() and torch.isfinite(err)
    pk = gk.pack_graph(tg, p0.shape[0])
    assert float(err) <= float(gk.chi2_reference(opt, pk, 1.0))
    assert float(gk.chi2_reference(again, pk, 1.0)) == float(err)


def test_chordal_init_and_auto_init_match_jax():
    """Heavy heading noise (as tests/test_init.py, cut to 200 poses): the
    odometry start is hopeless, so auto_init takes the chordal bootstrap."""
    data = datasets.manhattan(n_poses=200, rot_sigma=0.06, trans_sigma=0.05, seed=31)
    jg = jfrom_dataset(data)
    tg = carry(jg)
    jauto = np.asarray(jlm.auto_init_poses(jnp.asarray(data["poses"]), jg))
    assert not np.array_equal(jauto, data["poses"])  # JAX took the bootstrap
    out = chordal_init_se2(tg, 200)
    assert wrapped_max(out.numpy(), jauto) <= 1e-3
    auto = lm.auto_init_poses(torch.from_numpy(data["poses"]), tg)
    assert torch.equal(auto, out)


def test_damped_diag_without_scaling_and_2x2_block_inv_match_jax(small):
    jg, tg, p0 = small
    jsys = jax.jit(lambda p: jne.build_blocks(jlinearize(p, jg), jg, p.shape[0]))(jnp.asarray(p0))
    tsys = ne.build_blocks(linearize(torch.from_numpy(p0), tg), tg, p0.shape[0])
    for scaling in (True, False):
        ours = ne._damped_diag(tsys, 1e-2, scaling)
        ref = np.asarray(jne._damped_diag(jsys, jnp.float32(1e-2), scaling))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=1e-4, atol=1e-4 * np.abs(ref).max())
    M = np.random.default_rng(0).normal(size=(64, 2, 2))
    spd = (M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(2)).astype(np.float32)
    np.testing.assert_allclose(ne._block_inv(torch.from_numpy(spd)).numpy(),
                               np.asarray(jne._block_inv(jnp.asarray(spd))), rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(ne._block_inv(torch.from_numpy(spd)).numpy(), np.linalg.inv(spd),
                               rtol=1e-4, atol=1e-4)
