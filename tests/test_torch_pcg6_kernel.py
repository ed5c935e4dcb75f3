"""The fused SE(3) PCR-preconditioned CG of the port (ops/pcg6_kernel.py, K5) on the CPU.

On CPU tensors `fused_pcg6_solve` runs its plain torch twin, held here to
graphslam_tpu:
  * to the Pallas kernel `fused_pcg6_solve` in interpret mode, once, on
    tests/test_pcg6_kernel.py's chain-only system (sphere(5, 8),
    max_iters=6): 1e-4 of the largest entry (float32 on both sides; the
    chain-only system has no loop gathers, so the TPU kernel's bf16 hi/lo
    splits do not enter);
  * run to convergence in float64, to the dense Cholesky solve of the
    same system: 1e-3 of the largest entry, the check of
    tests/test_pcg6_kernel.py:30 (which holds the JAX kernel to 2e-3 at
    40 iterations);
  * `_gn_loop` and `_lm_loop` in mode pcg_fused to the JAX XLA path: chi2
    within 1%, and LM poses within 8e-3 over the 12 pose entries from
    lam0 = 1, where the damped solves converge (see
    tests/test_torch_gn6_kernel.py for why undamped poses are not compared
    across preconditioners).
The CUDA kernel itself is held to the twin in
tests/test_torch_gn6_kernel_cuda.py and in chip_smoke.py, on the card.
Time: ~45 s on one worker (my CPU run), ~20 s of it the interpret-mode call.
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
from graphslam_tpu.ops.pcg6_kernel import fused_pcg6_solve as jfused_pcg6_solve
from graphslam_tpu.solver import lm as jlm
from graphslam_tpu.solver import normal_eq as jne
from graphslam_tpu_torch.config import SolverConfig
from graphslam_tpu_torch.factors import chi2
from graphslam_tpu_torch.factors.linearize import linearize
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops import pcg6_kernel as p6
from graphslam_tpu_torch.ops import pcg_kernel as pk
from graphslam_tpu_torch.solver import lm
from graphslam_tpu_torch.solver import normal_eq as ne

from _torch_port import carry, se3_max


def _port_sys(jsys):
    return ne.BlockSystem(*(torch.from_numpy(np.array(a)) for a in jsys))


def _system(n_rings, poses_per_ring, seed, chain_only=False):
    data = datasets.sphere(n_rings=n_rings, poses_per_ring=poses_per_ring, seed=seed)
    jg = jfrom_dataset(data)
    if chain_only:
        keep = jnp.arange(jg.num_edges) < jg.chain_prefix
        jg = jg.replace(edge_mask=jg.edge_mask & keep)
    jsys = jax.jit(lambda p: jne.build_blocks(jlinearize(p, jg), jg, p.shape[0]))(
        jnp.asarray(data["poses"]))
    return jg, jsys, _port_sys(jsys), data["poses"]


def test_twin_matches_jax_kernel_interpret():
    """The one interpret-mode call of this file."""
    jg, jsys, tsys, _ = _system(5, 8, 1, chain_only=True)
    c, lam = jg.chain_prefix, 1e-3
    ref = np.asarray(jfused_pcg6_solve(jsys, jnp.float32(lam), max_iters=6, chain_prefix=c,
                                       interpret=True))
    out = p6.fused_pcg6_solve(tsys, torch.tensor(lam), max_iters=6, chain_prefix=c).numpy()
    assert np.abs(out - ref).max() <= 1e-4 * np.abs(ref).max()
    # and, as tests/test_pcg6_kernel.py:47, a handful of iterations reach the dense step
    exact = ne.dense_solve(tsys, torch.tensor(lam)).numpy()
    assert np.abs(out - exact).max() <= 5e-3 * max(np.abs(exact).max(), 1e-3)


@pytest.mark.parametrize("lam", [1e-3, 1e-2])
def test_twin_converged_matches_dense(lam):
    """In float64 at the damping of tests/test_pcg6_kernel.py:30 and above:
    undamped (lam 0), the PCR-preconditioned CG on this graph still ends
    2.9 off the dense step after 300 iterations (my CPU run, PR 4)."""
    jg, jsys, tsys, _ = _system(6, 8, 1)
    lam_t = torch.tensor(lam)
    sys64 = ne.BlockSystem(*(t.double() if t.is_floating_point() else t for t in tsys))
    dx = p6.fused_pcg6_solve(sys64, lam_t.double(), max_iters=300, chain_prefix=jg.chain_prefix)
    dense = ne.dense_solve(sys64, lam_t.double())
    assert np.abs((dx - dense).numpy()).max() <= 1e-3 * float(dense.abs().max())
    jdense = np.asarray(jne.dense_solve(jsys, jnp.float32(lam)))
    assert np.abs(dx.numpy() - jdense).max() <= 1e-3 * np.abs(jdense).max()


def test_gn_and_lm_loops_pcg_fused_match_xla():
    data = datasets.sphere(n_rings=4, poses_per_ring=6, seed=9)
    jg = jfrom_dataset(data)
    tg, p0 = carry(jg), data["poses"]
    kw = dict(cg_max_iterations=20, cg_tol=0.0)
    ref = np.asarray(jlm._gn_loop(jnp.asarray(p0), jg, JSolverConfig(mode="pcg", **kw), "pcg", 3))
    before = p6.fused_pcg6_solve.launches
    out = lm._gn_loop(torch.from_numpy(p0), tg, SolverConfig(mode="pcg_fused", **kw),
                      "pcg_fused", 3)
    assert p6.fused_pcg6_solve.launches == before  # CPU tensors: the twin
    c, cj = float(chi2(out, tg)), float(jchi2(jnp.asarray(ref), jg))
    assert abs(c - cj) <= 1e-2 * cj
    lkw = dict(cg_max_iterations=25, cg_tol=0.0, max_iterations=4, use_huber_on_loops=True,
               rel_decrease_tol=0.0, abs_decrease_tol=0.0, init_lambda=1.0)
    jst = jlm._lm_loop(jnp.asarray(p0), jg, JSolverConfig(mode="pcg", **lkw), "pcg")
    st = lm._lm_loop(torch.from_numpy(p0), tg, SolverConfig(mode="pcg_fused", **lkw), "pcg_fused")
    assert se3_max(st.poses.numpy(), jst.poses) <= 8e-3
    assert abs(float(st.error) - float(jst.error)) <= 1e-2 * float(jst.error)
    assert int(st.iterations) == int(jst.iterations)
    assert bool(st.converged) == bool(jst.converged)


def test_zero_loop_blocks_leave_the_csr_and_add_nothing():
    """Masked loop slots (zero blocks, endpoints clipped onto node 0) stay
    out of K5's CSR, and the solve equals the one without those slots."""
    data = datasets.sphere(n_rings=4, poses_per_ring=6, seed=3)
    tg = carry(jfrom_dataset(data))
    c, N, extra = tg.chain_prefix, data["poses"].shape[0], 20
    ident = torch.tensor([1.0, 0, 0, 0, 1, 0, 0, 0, 1, 0, 0, 0])
    tm = tg.replace(
        edges=torch.cat([tg.edges, torch.zeros((extra, 2), dtype=torch.int32)]),
        measurements=torch.cat([tg.measurements, ident.expand(extra, 12)]),
        sqrt_info=torch.cat([tg.sqrt_info, torch.eye(6).expand(extra, 6, 6)]),
        edge_mask=torch.cat([tg.edge_mask, torch.zeros(extra, dtype=torch.bool)]),
        is_loop=torch.cat([tg.is_loop, torch.ones(extra, dtype=torch.bool)]),
    )
    p = torch.from_numpy(data["poses"])
    sys_m = ne.build_blocks(linearize(p, tm), tm, N)
    D, U, b, li, lj, A = p6._chain_and_loops(sys_m, 0.0, True, c, T=6)
    live = pk.live_loops(A)
    assert live.tolist() == tm.edge_mask[c:].tolist()
    ptr, ent = gk.edge_csr(li, lj, live, N)
    assert int(ptr[-1]) == 2 * int(live.sum())
    keep = torch.cat([torch.ones(c, dtype=torch.bool), live])
    sys_k = ne.BlockSystem(*(t[keep] for t in sys_m[:3]), sys_m.diag, sys_m.g, sys_m.edges[keep])
    x_m = p6.fused_pcg6_solve(sys_m, 1e-3, max_iters=25, chain_prefix=c)
    x_k = p6.fused_pcg6_solve(sys_k, 1e-3, max_iters=25, chain_prefix=c)
    assert torch.equal(x_m, x_k)


def test_cpu_path_is_the_twin_and_counts_no_launch():
    _, _, tsys, _ = _system(4, 6, 9)
    before = p6.fused_pcg6_solve.launches
    out = p6.fused_pcg6_solve(tsys, 1e-3, max_iters=10, chain_prefix=23)
    ref = p6.fused_pcg6_solve_reference(tsys, 1e-3, max_iters=10, chain_prefix=23)
    assert torch.equal(out, ref)
    assert p6.fused_pcg6_solve.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors():
    _, _, tsys, _ = _system(4, 6, 9)
    args = p6._chain_and_loops(tsys, 0.0, True, 23, T=6)
    with pytest.raises(ValueError, match="CUDA"):
        p6.Pcg6Kernel(*args, 25)
    meta = ne.BlockSystem(*(t.to("meta") for t in tsys))
    with pytest.raises(ValueError, match="CUDA"):
        p6.fused_pcg6_solve(meta, 0.0, chain_prefix=23)
    three = tsys._replace(g=torch.zeros(tsys.g.shape[0], 3))
    with pytest.raises(ValueError, match="T=6"):
        p6.fused_pcg6_solve(three, 0.0)
