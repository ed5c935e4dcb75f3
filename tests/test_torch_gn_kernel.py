"""The fused GN kernel of the port (ops/gn_kernel.py) on the CPU.

On CPU tensors `fused_gn_solve` runs the kernel's plain torch twin, which is
held here to graphslam_tpu's Pallas kernel run in interpret mode, as
tests/test_gn_kernel.py runs it (three calls: they cost seconds each).
Tolerances are that file's: poses within wrapped atol 2e-3 (3e-3 with
Huber), chi2 within 1%. Angles are compared modulo 2*pi. The CUDA kernel
itself is held to the twin in tests/test_torch_gn_kernel_cuda.py and in
chip_smoke.py, on the card.
"""

import os
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.config import SolverConfig as JSolverConfig
from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.linearize import chi2 as jchi2
from graphslam_tpu.io import datasets
from graphslam_tpu.ops.gn_kernel import fused_gn_solve as jfused_gn_solve
from graphslam_tpu.solver.lm import _gn_loop as j_gn_loop
from graphslam_tpu_torch.factors import chi2
from graphslam_tpu_torch.ops import _build
from graphslam_tpu_torch.ops import gn_kernel as gk

from _torch_port import carry, wrapped_max

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module")
def small():
    data = datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)
    jg = jfrom_dataset(data)
    return jg, carry(jg), data["poses"]


@pytest.mark.parametrize(
    "pcr_levels, huber_delta, atol",
    [(4, -1.0, 2e-3), (None, -1.0, 2e-3), (4, 1.0, 3e-3)],
    ids=["pcr4", "pcr_exact", "huber"],
)
def test_twin_matches_jax_kernel_interpret(small, pcr_levels, huber_delta, atol):
    jg, tg, p0 = small
    kw = dict(iterations=5, cg_iters=25, huber_delta=huber_delta, pcr_levels=pcr_levels)
    ref = jfused_gn_solve(jnp.asarray(p0), jg, interpret=True, **kw)
    out = gk.fused_gn_solve(torch.from_numpy(p0), tg, **kw)
    assert torch.isfinite(out).all()
    assert wrapped_max(out.numpy(), ref) <= atol
    ckw = dict(huber_delta=huber_delta, use_huber=huber_delta > 0)
    c, cj = float(chi2(out, tg, **ckw)), float(jchi2(ref, jg, **ckw))
    assert abs(c - cj) <= 1e-2 * max(cj, 1.0), (c, cj)


def _perturbed(data, seed):
    rng = np.random.default_rng(seed)
    noise = rng.normal(scale=[0.1, 0.1, 0.02], size=data["poses"].shape)
    noise[0] = 0.0
    return (data["poses"] + noise).astype(np.float32)


@pytest.mark.parametrize("case", ["chain_only", "masked"])
def test_twin_matches_xla_dense_newton(case):
    """CPU-only cases against JAX's XLA dense GN (exact Newton steps): with
    the exact PCR preconditioner and CG run to convergence (100 iterations)
    the fused twin takes the same steps. chain_only has no loop edges
    (El = 0); masked drops a mid-chain edge and two loop edges through
    edge_mask."""
    if case == "chain_only":
        data = datasets.manhattan(n_poses=150, loop_prob=0.0, seed=1)
        jg = jfrom_dataset(data)
        assert jg.num_edges == jg.chain_prefix
    else:
        data = datasets.manhattan(n_poses=140, loop_prob=0.5, seed=2)
        jg = jfrom_dataset(data)
        E, c = jg.num_edges, jg.chain_prefix
        jg = jg.replace(edge_mask=jg.edge_mask.at[E - 1].set(False)
                        .at[c + 1].set(False).at[c // 2].set(False))
    p0 = _perturbed(data, seed=3)
    ref = j_gn_loop(jnp.asarray(p0), jg, JSolverConfig(mode="dense"), "dense", 3)
    out = gk.fused_gn_solve(torch.from_numpy(p0), carry(jg), iterations=3, cg_iters=100)
    assert wrapped_max(out.numpy(), ref) <= 2e-3


def test_cpu_path_is_the_twin_and_counts_no_launch(small):
    jg, tg, p0 = small
    before = gk.fused_gn_solve.launches
    kw = dict(iterations=2, cg_iters=10, pcr_levels=4, warm_start=True, cg_ramp=((1, 10), (1, 6)))
    out = gk.fused_gn_solve(torch.from_numpy(p0), tg, **kw)
    assert torch.equal(out, gk.fused_gn_solve_reference(torch.from_numpy(p0), tg, **kw))
    assert gk.fused_gn_solve.launches == before


def test_warm_start_at_optimum_stays_finite(small):
    """Krylov-exhaustion guard: at the optimum the CG right-hand side is
    roundoff, pAp can reach <= 0, and the guard freezes the update."""
    jg, tg, p0 = small
    opt = gk.fused_gn_solve(torch.from_numpy(p0), tg, iterations=6, cg_iters=20)
    again = gk.fused_gn_solve(opt, tg, iterations=8, cg_iters=25, warm_start=True)
    assert torch.isfinite(again).all()
    assert float(chi2(again, tg)) <= float(chi2(opt, tg)) * (1 + 1e-3) + 1e-6


def test_kernel_inverse_and_ridge():
    rng = np.random.default_rng(0)
    M = rng.normal(size=(64, 3, 3))
    spd = torch.from_numpy(M @ np.swapaxes(M, -1, -2) + 0.5 * np.eye(3))
    np.testing.assert_allclose(gk._binv(spd).numpy(), np.linalg.inv(spd.numpy()), rtol=1e-9)
    r = gk._ridge(spd, 3e-4) - spd
    tr = np.trace(spd.numpy(), axis1=-2, axis2=-1)
    np.testing.assert_allclose(np.diagonal(r.numpy(), axis1=-2, axis2=-1),
                               np.repeat((1e-4 * np.abs(tr) + 1e-8)[:, None], 3, 1), rtol=1e-12)
    assert gk._binv(torch.zeros(1, 3, 3)).isfinite().all()


def test_loop_csr_lists_incident_edges_in_order(small):
    jg, tg, p0 = small
    pk = gk.pack_graph(tg, p0.shape[0])
    ptr, ent = gk.loop_csr(pk)
    li, lj = pk.loop_i.numpy(), pk.loop_j.numpy()
    assert ptr[0] == 0 and ptr[-1] == 2 * pk.El
    for n in range(pk.N):
        got = ent[ptr[n]:ptr[n + 1]].numpy()
        want = sorted([2 * l for l in np.nonzero(li == n)[0]]
                      + [2 * l + 1 for l in np.nonzero(lj == n)[0]])
        assert got.tolist() == want


def test_loop_csr_leaves_out_masked_edges(small):
    jg, tg, p0 = small
    mask = tg.edge_mask.clone()
    c = tg.chain_prefix
    mask[c::3] = False
    pk = gk.pack_graph(tg.replace(edge_mask=mask), p0.shape[0])
    ptr, ent = gk.loop_csr(pk)
    live = mask[c:].numpy()
    li, lj = pk.loop_i.numpy(), pk.loop_j.numpy()
    assert ptr[0] == 0 and ptr[-1] == 2 * live.sum()
    for n in range(pk.N):
        want = sorted([2 * l for l in np.nonzero((li == n) & live)[0]]
                      + [2 * l + 1 for l in np.nonzero((lj == n) & live)[0]])
        assert ent[ptr[n]:ptr[n + 1]].numpy().tolist() == want


def test_kernel_wrapper_refuses_non_cuda_tensors(small, tmp_path, monkeypatch):
    jg, tg, p0 = small
    with pytest.raises(ValueError, match="CUDA"):
        gk.GnKernel(torch.from_numpy(p0), tg)
    meta = torch.empty((p0.shape[0], 3), device="meta")
    with pytest.raises(ValueError, match="CUDA"):
        gk.fused_gn_solve(meta, tg.to("meta"), iterations=1)
    # no nvcc: the build raises instead of falling back
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.setenv("CUDA_HOME", str(tmp_path))
    with pytest.raises(RuntimeError, match="nvcc"):
        _build.build("gn_kernel")


def test_port_imports_no_jax():
    code = (
        "import sys\n"
        "import graphslam_tpu_torch.solver.lm, graphslam_tpu_torch.ops.gn_kernel\n"
        "import graphslam_tpu_torch.metrics, graphslam_tpu_torch.utils\n"
        "import graphslam_tpu_torch.io, graphslam_tpu_torch.factors\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'graphslam_tpu'))\n"
        "print(bad)\n"
        "sys.exit(1 if bad else 0)\n"
    )
    env = dict(os.environ, PYTHONPATH=str(REPO))
    proc = subprocess.run([sys.executable, "-c", code], cwd=str(REPO), env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stdout + proc.stderr
