"""The fused SE(3) GN/LM kernel of the port (ops/gn6_kernel.py, K4) on the CPU.

On CPU tensors `fused_gn6_solve` and `fused_lm6_solve` run the kernel's
plain torch twins, held here to graphslam_tpu:
  * the GN twin to the Pallas kernel `fused_gn6_solve` in interpret mode,
    once, at tests/test_gn6_kernel.py's smallest config (sphere(6, 8), 2
    iterations, cg 8, pcr_levels=2; ~65 s on the CPU);
  * the LM twin to the JAX `_lm_loop(mode="pcg")`, the XLA path, with both
    convergence tolerances 0 so the loop's early exit cannot part them;
  * `_gn_loop` and `lm_solve` in mode gn_fused to the JAX XLA path;
  * K4's assembled system (masked edges, a prior on every node, damping)
    to the XLA path's build_blocks, in float64.
Tolerances are the JAX repo's SE(3) kernel-vs-XLA ones
(tests/test_gn6_kernel.py:37 and :87): poses within 5e-3 over the 12 pose
entries for GN, 8e-3 for LM with Huber; chi2 within 1%; assembled blocks
rtol 1e-5; the 6x6 inverse in float64 against numpy rtol 1e-9.

Poses are held to the XLA path only where both sides' linear solves
converge. The kernels precondition CG by PCR with a ridge at every level,
the XLA path by cyclic reduction; on these graphs (condition number ~1e8)
20-25 CG iterations stop at different points, and the JAX package's own
modes pcg and pcg_fused end 0.021 apart after 3 GN iterations and 0.032
apart after 3 LM iterations on sphere(4, 6) (my CPU run, PR 4), the port
0.021 and 0.032 from mode pcg. So the undamped comparisons hold chi2
against the XLA path and poses against the same preconditioner through
the port's unfused loop; LM poses are held to XLA from lam0 = 1, where the
damped solves converge (4.3e-4 apart).
The CUDA kernel itself is held to the twins in
tests/test_torch_gn6_kernel_cuda.py and in chip_smoke.py, on the card.
Time: ~90 s on one worker (my CPU run), ~65 s of it the one interpret-mode
call.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import SolverConfig as JSolverConfig
from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.linearize import chi2 as jchi2
from graphslam_tpu.factors.linearize import linearize as jlinearize
from graphslam_tpu.io import datasets
from graphslam_tpu.ops.gn6_kernel import fused_gn6_solve as jfused_gn6_solve
from graphslam_tpu.solver import lm as jlm
from graphslam_tpu.solver import normal_eq as jne
from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import chi2
from graphslam_tpu_torch.factors.linearize import linearize
from graphslam_tpu_torch.ops import gn6_kernel as g6
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.solver import lm
from graphslam_tpu_torch.solver import normal_eq as ne

from _torch_port import carry, se3_max

GN_ATOL, LM_ATOL = 5e-3, 8e-3
HUBER = dict(huber_delta=1.0, use_huber=True)


def _graph(n_rings, poses_per_ring, seed):
    data = datasets.sphere(n_rings=n_rings, poses_per_ring=poses_per_ring, seed=seed)
    jg = jfrom_dataset(data)
    return jg, carry(jg), data["poses"]


@pytest.fixture(scope="module")
def small():
    """sphere(4, 6): 24 poses, 18 loop edges."""
    return _graph(4, 6, 9)


def test_twin_matches_jax_kernel_interpret():
    """The one interpret-mode call of this file (tests/test_gn6_kernel.py's
    smallest config), used by this test alone so that no other worker
    repeats it."""
    jg, tg, p0 = _graph(6, 8, 1)
    kw = dict(iterations=2, cg_iters=8, pcr_levels=2)
    ref = np.asarray(jfused_gn6_solve(jnp.asarray(p0), jg, interpret=True, **kw))
    out = g6.fused_gn6_solve(torch.from_numpy(p0), tg, **kw)
    assert torch.isfinite(out).all()
    assert se3_max(out.numpy(), ref) <= GN_ATOL
    c, cj = float(chi2(out, tg)), float(jchi2(jnp.asarray(ref), jg))
    assert abs(c - cj) <= 1e-2 * cj, (c, cj)


def test_lm_twin_matches_jax_lm_loop(small):
    """From lam0 = 1 the damped solves converge in 25 CG iterations, so the
    twin's poses are held to the XLA loop's; from the default lam0 = 1e-5
    they are not (module docstring), and the twin is held to JAX on chi2,
    lambda and the accepted steps, and to the port's _lm_loop(pcg_fused),
    the same preconditioner through linearize + build_blocks + K5's twin,
    on poses."""
    jg, tg, p0 = small
    base = dict(cg_tol=0.0, max_iterations=3, rel_decrease_tol=0.0, abs_decrease_tol=0.0,
                use_huber_on_loops=True, huber_delta=1.0)
    for lam0, cg in ((1.0, 25), (1e-5, 15)):
        kw = dict(base, cg_max_iterations=cg, init_lambda=lam0)
        ref = jlm._lm_loop(jnp.asarray(p0), jg, JSolverConfig(mode="pcg", **kw), "pcg")
        out, err, lam, n_acc, conv = g6.fused_lm6_solve(
            torch.from_numpy(p0), tg, iterations=3, cg_iters=cg, huber_delta=1.0, lam0=lam0,
            abs_tol=0.0, rel_tol=0.0)
        assert all(t.shape == () for t in (err, lam, n_acc, conv))
        assert abs(float(err) - float(ref.error)) <= 1e-2 * float(ref.error)
        assert int(n_acc) == int(ref.iterations) == 3 and float(conv) == 0.0
        assert float(lam) == pytest.approx(float(ref.lam), rel=1e-6)
        if lam0 == 1.0:
            assert se3_max(out.numpy(), ref.poses) <= LM_ATOL
        else:
            loop = lm._lm_loop(torch.from_numpy(p0), tg, SolverConfig(mode="pcg_fused", **kw),
                               "pcg_fused")
            assert se3_max(out.numpy(), loop.poses.numpy()) <= LM_ATOL
    # the kernel's cost is the XLA chi2 with Huber where every non-chain edge is a loop
    pk = g6.pack_graph6(tg, p0.shape[0])
    c = float(chi2(out, tg, **HUBER))
    assert abs(float(g6.chi2_reference6(out, pk, 1.0)) - c) <= 1e-5 * c


def test_gn_loop_and_lm_solve_gn_fused_match_xla(small):
    jg, tg, p0 = small
    p = torch.from_numpy(p0)
    kw = dict(cg_max_iterations=20, cg_tol=0.0)
    ref = np.asarray(jlm._gn_loop(jnp.asarray(p0), jg, JSolverConfig(mode="pcg", **kw), "pcg", 3))
    out = lm._gn_loop(p, tg, SolverConfig(mode="gn_fused", **kw), "gn_fused", 3)
    c, cj = float(chi2(out, tg)), float(jchi2(jnp.asarray(ref), jg))
    assert abs(c - cj) <= 1e-2 * cj
    loop = lm._gn_loop(p, tg, SolverConfig(mode="pcg_fused", **kw), "pcg_fused", 3)
    assert se3_max(out.numpy(), loop.numpy()) <= GN_ATOL
    lkw = dict(cg_max_iterations=25, cg_tol=0.0, max_iterations=4, use_huber_on_loops=True,
               rel_decrease_tol=0.0, abs_decrease_tol=0.0, init_lambda=1.0)
    jst = jlm.lm_solve(jnp.asarray(p0), jg, JSolverConfig(mode="pcg", **lkw))
    st = lm.lm_solve(p, tg, SolverConfig(mode="gn_fused", **lkw))
    assert se3_max(st.poses.numpy(), jst.poses) <= LM_ATOL
    assert abs(float(st.error) - float(jst.error)) <= 1e-2 * float(jst.error)
    assert st.iterations.dtype == torch.int32 and int(st.iterations) == int(jst.iterations)


def _system_matches_xla(tg, jg, p0, rtol=1e-5):
    """K4's assembled D and b (twin) against the XLA path's damped
    build_blocks, in float64 (the Jacobians cancel in float32, see
    tests/test_torch_se3.py), and against the port's build_blocks."""
    import jax

    p64 = p0.astype(np.float64)
    t64 = tg.replace(measurements=tg.measurements.double(), sqrt_info=tg.sqrt_info.double(),
                     prior_meas=tg.prior_meas.double(), prior_sqrt_info=tg.prior_sqrt_info.double())
    sysm = g6.system_reference6(torch.from_numpy(p64), g6.pack_graph6(t64, p0.shape[0]), lam=0.5)
    with jax.enable_x64(True):
        j64 = jg.replace(**{f: jnp.asarray(np.asarray(getattr(jg, f)), jnp.float64) for f in (
            "measurements", "sqrt_info", "prior_meas", "prior_sqrt_info")})

        @jax.jit
        def damped(x):
            jsys = jne.build_blocks(jlinearize(x, j64), j64, p0.shape[0])
            return jne._damped_diag(jsys, jnp.float64(0.5), True), jsys.g

        D, g = (np.asarray(t) for t in damped(jnp.asarray(p64)))
    np.testing.assert_allclose(sysm.D.numpy(), D, rtol=rtol, atol=rtol * np.abs(D).max())
    np.testing.assert_allclose(sysm.b.numpy(), -g, rtol=rtol, atol=rtol * np.abs(g).max())
    tsys = ne.build_blocks(linearize(torch.from_numpy(p64), t64), t64, p0.shape[0])
    np.testing.assert_allclose(sysm.D.numpy(), ne._damped_diag(tsys, 0.5).numpy(), rtol=rtol,
                               atol=rtol * np.abs(D).max())


def test_one_prior_per_node_matches_xla(small):
    """K4 keeps one prior per node (a scatter-set, as the TPU kernel) where
    the XLA path sums repeated ones; with one prior per node they agree."""
    jg, tg, p0 = small
    N = p0.shape[0]
    gt = datasets.sphere(n_rings=4, poses_per_ring=6, seed=9)["gt"]
    jp = jg.replace(prior_idx=jnp.arange(N, dtype=jnp.int32), prior_meas=jnp.asarray(gt),
                    prior_sqrt_info=jnp.broadcast_to(jnp.eye(6, dtype=jnp.float32), (N, 6, 6)),
                    prior_mask=jnp.ones(N, bool))
    tp = carry(jp)
    _system_matches_xla(tp, jp, p0)
    pk = g6.pack_graph6(tp, N)
    assert torch.equal(pk.prior_z, tp.prior_meas) and torch.equal(pk.prior_R, tp.prior_sqrt_info)
    # a repeated index keeps the last of its priors; a masked prior is none
    rep = tp.replace(prior_idx=torch.tensor([0, 3, 0], dtype=torch.int32),
                     prior_meas=tp.prior_meas[:3], prior_sqrt_info=tp.prior_sqrt_info[:3],
                     prior_mask=torch.tensor([True, False, True]))
    pk = g6.pack_graph6(rep, N)
    assert torch.equal(pk.prior_z[0], tp.prior_meas[2])
    assert torch.equal(pk.prior_R[0], tp.prior_sqrt_info[2])
    ident = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0])
    assert torch.equal(pk.prior_z[3], ident) and not pk.prior_R[3].any()
    assert not pk.prior_R[1].any() and torch.equal(pk.prior_z[1], ident)


def test_masked_edges_carry_identity_and_no_weight(small):
    jg, tg, p0 = small
    E, c = tg.num_edges, tg.chain_prefix
    mask = tg.edge_mask.clone()
    mask[E - 1] = False
    mask[c - 2] = False
    gm = tg.replace(edge_mask=mask)
    pk = g6.pack_graph6(gm, p0.shape[0])
    assert not pk.chain_R[c - 2].any() and not pk.loop_R[-1].any()
    assert pk.chain_z[c - 2, [0, 4, 8]].tolist() == [1.0, 1.0, 1.0]
    ptr, ent = gk.loop_csr(pk)
    assert int(ptr[-1]) == 2 * (pk.El - 1)
    _system_matches_xla(gm, jg.replace(edge_mask=jnp.asarray(mask.numpy())), p0)


def test_warm_start_and_ramp_converge_like_flat(small):
    """As tests/test_gn6_kernel.py::test_fused_gn6_warm_start_and_ramp, on the
    twin: warm starts and phased CG budgets reach the same quality."""
    jg, tg, p0 = small
    p = torch.from_numpy(p0)
    kw = dict(iterations=2, cg_iters=8, pcr_levels=2)
    flat = g6.fused_gn6_solve(p, tg, **kw)
    ramp = g6.fused_gn6_solve(p, tg, warm_start=True, cg_ramp=((1, 8), (1, 6)), **kw)
    c0, c_flat, c = float(chi2(p, tg)), float(chi2(flat, tg)), float(chi2(ramp, tg))
    assert c < 0.05 * c0, (c, c0)
    assert abs(c - c_flat) < 0.15 * max(c_flat, 1.0), (c, c_flat)
    # Krylov-exhaustion guard: warm CG at the optimum stays finite
    opt = g6.fused_gn6_solve(p, tg, iterations=6, cg_iters=20)
    again = g6.fused_gn6_solve(opt, tg, iterations=6, cg_iters=25, warm_start=True)
    assert torch.isfinite(again).all()
    assert float(chi2(again, tg)) <= float(chi2(opt, tg)) * (1 + 1e-3) + 1e-6


def test_kernel_inverse_and_ridge():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 6, 6))
    spd = torch.from_numpy(M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(6))
    np.testing.assert_allclose(g6.binv6(spd).numpy(), np.linalg.inv(spd.numpy()), rtol=1e-9,
                               atol=1e-12)
    r = g6.ridge6(spd, 3e-4) - spd
    tr = np.trace(spd.numpy(), axis1=-2, axis2=-1)
    np.testing.assert_allclose(np.diagonal(r.numpy(), axis1=-2, axis2=-1),
                               np.repeat((5e-5 * np.abs(tr) + 1e-8)[:, None], 6, 1), rtol=1e-12)
    assert g6.binv6(torch.zeros(1, 6, 6)).isfinite().all()


def test_cpu_path_is_the_twin_and_counts_no_launch(small):
    jg, tg, p0 = small
    p = torch.from_numpy(p0)
    b_gn, b_lm = g6.fused_gn6_solve.launches, g6.fused_lm6_solve.launches
    assert torch.equal(g6.fused_gn6_solve(p, tg, iterations=2, cg_iters=5),
                       g6.fused_gn6_solve_reference(p, tg, iterations=2, cg_iters=5))
    out = g6.fused_lm6_solve(p, tg, iterations=2, cg_iters=5)
    ref = g6.fused_lm6_solve_reference(p, tg, iterations=2, cg_iters=5)
    assert all(torch.equal(a, b) for a, b in zip(out, ref))
    assert (g6.fused_gn6_solve.launches, g6.fused_lm6_solve.launches) == (b_gn, b_lm)


def test_kernel_wrapper_refuses_non_cuda_tensors(small):
    jg, tg, p0 = small
    with pytest.raises(ValueError, match="CUDA"):
        g6.Gn6Kernel(torch.from_numpy(p0), tg)
    meta = torch.empty(p0.shape, device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        g6.fused_gn6_solve(meta, tg)
    with pytest.raises(ValueError, match="CUDA"):
        g6.fused_lm6_solve(meta, tg)
    se2 = carry(jfrom_dataset(datasets.manhattan(n_poses=50, seed=0)))
    with pytest.raises(ValueError, match="SE\\(3\\)"):
        g6.pack_graph6(se2, 50)
