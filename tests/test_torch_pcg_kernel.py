"""The fused PCR-preconditioned CG of the port (ops/pcg_kernel.py, K3) on the CPU.

On CPU tensors `fused_pcg_solve` runs its plain torch twin, held here to
graphslam_tpu's Pallas kernel run in interpret mode, as
tests/test_pcg_kernel.py runs it. Systems are built in JAX and fed to both
sides as the same numpy arrays. Tolerances, float32:
  * against the JAX kernel: max |dx - dx_jax| <= 2e-4 max |dx_jax|. The
    JAX kernel's loop gathers ride the bf16 MXU with hi/lo splits, which
    leaves it up to 1.8e-4 (of the largest entry) off a float64 run of the
    same 25 CG iterations, the twin up to 3.1e-5
    (scripts/port_precision_report.py); the twin is held to that float64
    run at 5e-5;
  * run to convergence against the dense Cholesky solve: 1e-3 of the
    largest entry (test_pcg_kernel.py holds the JAX kernel to 8e-3).
The CUDA kernel itself is held to the twin in tests/test_torch_lm_cuda.py
and in chip_smoke.py, on the card.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.linearize import linearize as jlinearize
from graphslam_tpu.io import datasets
from graphslam_tpu.ops.pcg_kernel import fused_pcg_solve as jfused_pcg_solve
from graphslam_tpu.solver import normal_eq as jne
from graphslam_tpu_torch.factors.linearize import linearize
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops import pcg_kernel as pk
from graphslam_tpu_torch.solver import normal_eq as ne

from _torch_port import carry


def _port_sys(jsys, dtype=torch.float32):
    arrays = (np.array(a) for a in jsys)
    return ne.BlockSystem(*(
        torch.from_numpy(a).to(dtype) if a.dtype == np.float32 else torch.from_numpy(a)
        for a in arrays
    ))


@pytest.fixture(scope="module")
def small():
    """manhattan(200): JAX graph, JAX BlockSystem, port BlockSystem."""
    data = datasets.manhattan(n_poses=200, loop_prob=0.25, seed=0)
    jg = jfrom_dataset(data)
    jsys = jax.jit(lambda p: jne.build_blocks(jlinearize(p, jg), jg, p.shape[0]))(
        jnp.asarray(data["poses"]))
    return jg, jsys, _port_sys(jsys)


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_twin_matches_jax_kernel_interpret(small, lam):
    jg, jsys, tsys = small
    c = jg.chain_prefix
    ref = np.asarray(jfused_pcg_solve(jsys, jnp.float32(lam), max_iters=25, chain_prefix=c,
                                      interpret=True))
    out = pk.fused_pcg_solve(tsys, torch.tensor(lam), max_iters=25, chain_prefix=c).numpy()
    assert np.abs(out - ref).max() <= 2e-4 * np.abs(ref).max()
    x64 = pk.fused_pcg_solve(_port_sys(jsys, torch.float64), torch.tensor(lam, dtype=torch.float64),
                             max_iters=25, chain_prefix=c).numpy()
    assert np.abs(out - x64).max() <= 5e-5 * np.abs(x64).max()


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_twin_converged_matches_dense(small, lam):
    jg, jsys, tsys = small
    lam_t = torch.tensor(lam)
    dx = pk.fused_pcg_solve(tsys, lam_t, max_iters=120, chain_prefix=jg.chain_prefix)
    dense = ne.dense_solve(tsys, lam_t)
    assert np.abs((dx - dense).numpy()).max() <= 1e-3 * float(dense.abs().max())
    jdense = np.asarray(jne.dense_solve(jsys, jnp.float32(lam)))
    assert np.abs(dx.numpy() - jdense).max() <= 1e-3 * np.abs(jdense).max()


def test_chain_only_one_iteration_is_exact():
    """On a pure chain exact PCR is the inverse: one CG step solves it."""
    data = datasets.manhattan(n_poses=150, loop_prob=0.0, seed=1)
    jg = jfrom_dataset(data)
    tg = carry(jg)
    p = torch.from_numpy(data["poses"])
    sys = ne.build_blocks(linearize(p, tg), tg, 150)
    dx = pk.fused_pcg_solve(sys, 0.0, max_iters=1, chain_prefix=tg.chain_prefix)
    dense = ne.dense_solve(sys, 0.0)
    assert np.abs((dx - dense).numpy()).max() <= 1e-3 * max(float(dense.abs().max()), 1.0)


def test_zero_loop_blocks_leave_the_csr_and_add_nothing():
    """Masked loop slots (zero blocks, endpoints clipped onto node 0, as in
    the online graph) stay out of K3's CSR, and the solve equals the one
    without those slots."""
    data = datasets.manhattan(n_poses=150, loop_prob=0.5, seed=2)
    tg = carry(jfrom_dataset(data))
    c, E = tg.chain_prefix, tg.num_edges
    assert E - c >= 4
    extra = 40
    edges = torch.cat([tg.edges, torch.zeros((extra, 2), dtype=torch.int32)])
    pad = dict(
        edges=edges,
        measurements=torch.cat([tg.measurements, torch.zeros(extra, 3)]),
        sqrt_info=torch.cat([tg.sqrt_info, torch.eye(3).expand(extra, 3, 3)]),
        edge_mask=torch.cat([tg.edge_mask, torch.zeros(extra, dtype=torch.bool)]),
        is_loop=torch.cat([tg.is_loop, torch.ones(extra, dtype=torch.bool)]),
    )
    mask = pad["edge_mask"].clone()
    mask[c + 1] = False  # one live loop edge masked in place
    tm = tg.replace(**{**pad, "edge_mask": mask})
    p = torch.from_numpy(data["poses"])
    sys_m = ne.build_blocks(linearize(p, tm), tm, 150)
    D, U, b, li, lj, A = pk._chain_and_loops(sys_m, 0.0, True, c)
    live = pk.live_loops(A)
    assert live.tolist() == mask[c:].tolist()
    ptr, ent = gk.edge_csr(li, lj, live, 150)
    assert int(ptr[-1]) == 2 * int(live.sum())
    kept = sorted({int(e) >> 1 for e in ent[: int(ptr[-1])]})
    assert kept == torch.nonzero(live).flatten().tolist()
    keep = torch.cat([torch.ones(c, dtype=torch.bool), live])
    sys_k = ne.BlockSystem(*(t[keep] for t in sys_m[:3]), sys_m.diag, sys_m.g, sys_m.edges[keep])
    x_m = pk.fused_pcg_solve(sys_m, 1e-3, max_iters=25, chain_prefix=c)
    x_k = pk.fused_pcg_solve(sys_k, 1e-3, max_iters=25, chain_prefix=c)
    assert torch.equal(x_m, x_k)


def test_cpu_path_is_the_twin_and_counts_no_launch(small):
    jg, jsys, tsys = small
    before = pk.fused_pcg_solve.launches
    out = pk.fused_pcg_solve(tsys, 1e-3, max_iters=10, chain_prefix=jg.chain_prefix)
    ref = pk.fused_pcg_solve_reference(tsys, 1e-3, max_iters=10, chain_prefix=jg.chain_prefix)
    assert torch.equal(out, ref)
    assert pk.fused_pcg_solve.launches == before


def test_kernel_wrapper_refuses_non_cuda_tensors(small):
    jg, jsys, tsys = small
    args = pk._chain_and_loops(tsys, 0.0, True, jg.chain_prefix)
    with pytest.raises(ValueError, match="CUDA"):
        pk.PcgKernel(*args, 25)
    meta = ne.BlockSystem(*(t.to("meta") for t in tsys))
    with pytest.raises(ValueError, match="CUDA"):
        pk.fused_pcg_solve(meta, 0.0, chain_prefix=jg.chain_prefix)
    six = tsys._replace(g=torch.zeros(tsys.g.shape[0], 6))
    with pytest.raises(ValueError, match="T=3"):
        pk.fused_pcg_solve(six, 0.0)
