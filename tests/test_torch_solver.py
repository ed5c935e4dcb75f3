"""The port's solver modules against graphslam_tpu's, and the m3500 slice.

Graphs are built in JAX and carried over with from_numpy; system blocks are
fed to both sides as the same numpy arrays. Tolerances, float32 throughout:
  * block assembly, H@v, PCR coefficients: rtol 1e-4, atol 1e-4 times the
    largest entry (sums of many products in another order);
  * CR/PCR solves and final inverses: 1e-3 likewise (a chain solve
    amplifies roundoff by the chain's conditioning);
  * poses after whole GN solves: wrapped atol 2e-3, the repo's
    kernel-vs-XLA tolerance (tests/test_gn_kernel.py);
  * m3500: the bench.py ATE gate, and chi2 within 1% of JAX's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu import config as jconfig
from graphslam_tpu import metrics as jmetrics
from graphslam_tpu.factors import from_dataset as jfrom_dataset
from graphslam_tpu.factors.linearize import chi2 as jchi2
from graphslam_tpu.factors.linearize import linearize as jlinearize
from graphslam_tpu.io import datasets
from graphslam_tpu.ops import pcg_kernel as jpcg
from graphslam_tpu.solver import lm as jlm
from graphslam_tpu.solver import normal_eq as jne
from graphslam_tpu.solver import tridiag as jtri
from graphslam_tpu_torch import config, metrics
from graphslam_tpu_torch.factors import chi2
from graphslam_tpu_torch.factors.linearize import linearize
from graphslam_tpu_torch.ops import pcg_kernel as pcg
from graphslam_tpu_torch.solver import lm
from graphslam_tpu_torch.solver import normal_eq as ne
from graphslam_tpu_torch.solver import tridiag as tri

from _torch_port import carry, wrapped_max

POSE_ATOL = 2e-3


def close(ours, ref, rtol=1e-4):
    ref = np.asarray(ref)
    a = ours.detach().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    np.testing.assert_allclose(a, ref, rtol=rtol, atol=rtol * np.abs(ref).max())


@pytest.fixture(scope="module")
def small():
    """manhattan(260): JAX graph, port graph, initial poses."""
    data = datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)
    jg = jfrom_dataset(data)
    return jg, carry(jg), data["poses"]


@pytest.fixture(scope="module")
def systems(small):
    """The same linearization as a JAX BlockSystem and a port BlockSystem."""
    jg, tg, p0 = small
    jsys = jax.jit(lambda p: jne.build_blocks(jlinearize(p, jg), jg, p.shape[0]))(
        jnp.asarray(p0))
    tsys = ne.build_blocks(linearize(torch.from_numpy(p0), tg), tg, p0.shape[0])
    return jsys, tsys


@pytest.mark.parametrize("name", ["SolverConfig", "FrontendConfig", "SLAMConfig", "MeshConfig"])
def test_config_defaults_identical(name):
    ours, ref = getattr(config, name)(), getattr(jconfig, name)()
    assert [f.name for f in dataclasses.fields(ours)] == [f.name for f in dataclasses.fields(ref)]
    for f in dataclasses.fields(ref):
        a, b = getattr(ours, f.name), getattr(ref, f.name)
        if dataclasses.is_dataclass(b):
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b, f.name


def test_build_blocks_matches(systems):
    jsys, tsys = systems
    for f in ("Aii", "Aij", "Ajj", "diag", "g"):
        close(getattr(tsys, f), getattr(jsys, f))


@pytest.mark.parametrize("lam", [0.0, 1e-3])
def test_hvp_and_damping_match(systems, small, lam):
    jsys, tsys = systems
    chain = small[0].chain_prefix
    v = np.random.default_rng(0).normal(size=tsys.g.shape).astype(np.float32)
    jd = jne._damped_diag(jsys, jnp.float32(lam), True)
    td = ne._damped_diag(tsys, lam)
    close(td, jd)
    close(ne.hvp(tsys, td, torch.from_numpy(v), chain), jne.hvp(jsys, jd, jnp.asarray(v), chain))
    close(ne._block_inv(td), jne._block_inv(jd))


def test_cr_factor_and_solve_match(systems):
    jsys, tsys = systems
    N = tsys.g.shape[0]
    jd = jne._damped_diag(jsys, jnp.float32(0.0), True)
    td = ne._damped_diag(tsys, 0.0)
    jU = jtri.chain_offdiag(jsys.edges, jsys.Aij, N)
    tU = tri.chain_offdiag(tsys.edges, tsys.Aij, N)
    close(tU, jU)
    jf, tf = jax.jit(jtri.cr_factor)(jd, jU), tri.cr_factor(td, tU)
    assert tf.root_n == jf.root_n and len(tf.levels) == len(jf.levels)
    b = np.random.default_rng(1).normal(size=(N, 3)).astype(np.float32)
    close(tri.cr_solve(tf, torch.from_numpy(b)), jtri.cr_solve(jf, jnp.asarray(b)), rtol=1e-3)


@pytest.mark.parametrize("levels", [None, 4])
def test_pcr_factor_and_apply_match(systems, levels):
    """JAX's pcr_factor always runs all ceil(log2 N) levels; its first four
    levels are the truncated factor's. The truncated apply is held to JAX's
    pcr_apply_reference fed those four levels and the port's final Dinv."""
    jsys, tsys = systems
    N = tsys.g.shape[0]
    jd = jne._damped_diag(jsys, jnp.float32(0.0), True)
    td = ne._damped_diag(tsys, 0.0)
    jU = jnp.concatenate([jtri.chain_offdiag(jsys.edges, jsys.Aij, N), jnp.zeros((1, 3, 3))])
    tU = torch.cat([tri.chain_offdiag(tsys.edges, tsys.Aij, N), torch.zeros(1, 3, 3)])
    jA, jG, jDinv = jax.jit(jpcg.pcr_factor)(jd, jU)
    A, G, Dinv = pcg.pcr_factor(td, tU, levels=levels)
    K = A.shape[0]
    assert K == (jA.shape[0] if levels is None else 4)
    close(A, jA[:K])
    close(G, jG[:K])
    b = np.random.default_rng(2).normal(size=(N, 3)).astype(np.float32)
    ours = pcg.pcr_apply_reference(A, G, Dinv, torch.from_numpy(b))
    if levels is None:
        close(Dinv, jDinv, rtol=1e-3)
        ref = jpcg.pcr_apply_reference(jA, jG, jDinv, jnp.asarray(b))
    else:
        ref = jpcg.pcr_apply_reference(jA[:K], jG[:K], jnp.asarray(Dinv.numpy()), jnp.asarray(b))
    close(ours, ref, rtol=1e-3)


@pytest.mark.parametrize("mode, preconditioner", [
    ("pcg", "tridiag"), ("pcg", "jacobi"), ("dense", "tridiag"),
])
def test_gn_loop_matches_jax(small, mode, preconditioner):
    jg, tg, p0 = small
    cfg = dict(mode=mode, cg_max_iterations=25, preconditioner=preconditioner)
    ref = jlm._gn_loop(jnp.asarray(p0), jg, jconfig.SolverConfig(**cfg), mode, 5)
    out = lm._gn_loop(torch.from_numpy(p0), tg, config.SolverConfig(**cfg), mode, 5)
    assert torch.isfinite(out).all()
    assert wrapped_max(out.numpy(), ref) <= POSE_ATOL


def test_gn_solve_auto_dispatch_and_unported_modes(small):
    jg, tg, p0 = small
    p = torch.from_numpy(p0)
    cfg = config.SolverConfig(mode="auto", dense_threshold=512)
    assert lm._solve_mode(cfg, 260) == "dense"
    assert lm._solve_mode(cfg, 513) == "pcg"
    auto = lm.gn_solve(p, tg, cfg, iterations=2)
    dense = lm._gn_loop(p, tg, cfg, "dense", 2)
    assert torch.equal(auto, dense)
    fused = lm._gn_loop(p, tg, cfg, "pcg_fused", 2)  # K3's twin on the CPU
    assert wrapped_max(fused.numpy(), dense.numpy()) <= POSE_ATOL
    with pytest.raises(ValueError, match="unknown solver mode"):
        lm._gn_loop(p, tg, cfg, "cholmod", 1)


def test_metrics_match(small):
    jg, tg, p0 = small
    gt = datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)["gt"]
    for align in (True, False):
        a = float(metrics.ate(torch.from_numpy(p0), torch.from_numpy(gt), align=align))
        b = float(jmetrics.ate(jnp.asarray(p0), jnp.asarray(gt), align=align))
        assert abs(a - b) <= 1e-5 * b
    for delta in (1, 7):
        a = float(metrics.rpe(torch.from_numpy(p0), torch.from_numpy(gt), delta))
        b = float(jmetrics.rpe(jnp.asarray(p0), jnp.asarray(gt), delta))
        assert abs(a - b) <= 1e-5 * b


def test_m3500_slice_end_to_end_cpu():
    """bench.py's headline solve through the port on the CPU: 50 GN
    iterations, cg 25, pcr_levels=4 through mode "gn_fused" (the kernel's
    plain twin runs for CPU tensors). JAX's reference chi2 comes from its
    XLA pcg path on the same graph."""
    data = datasets.m3500()
    jg = jfrom_dataset(data)
    tg = carry(jg)
    p0, gt = torch.from_numpy(data["poses"]), torch.from_numpy(data["gt"])
    cfg = dict(cg_max_iterations=25, cg_tol=1e-7, pcr_levels=4, edge_tile=512, hvp_splits=1)
    out = lm._gn_loop(p0, tg, config.SolverConfig(mode="gn_fused", **cfg), "gn_fused", 50)
    assert torch.isfinite(out).all()
    ate0, ate = float(metrics.ate(p0, gt)), float(metrics.ate(out, gt))
    assert ate < 0.35 and ate < 0.5 * ate0, (ate0, ate)
    ref = jlm._gn_loop(jnp.asarray(data["poses"]), jg,
                       jconfig.SolverConfig(mode="pcg", **cfg), "pcg", 50)
    c, cj = float(chi2(out, tg)), float(jchi2(ref, jg))
    assert abs(c - cj) <= 1e-2 * cj, (c, cj)
