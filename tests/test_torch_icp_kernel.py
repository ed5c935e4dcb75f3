"""The GICP iteration (K2) and nearest-target (K8) wrappers on the CPU.

On CPU tensors the wrappers run their plain torch twins, which are held
here to graphslam_tpu's references (and, for K2, to its Pallas kernel in
interpret mode, as tests/test_icp_kernel.py runs it). Inputs follow that
file's make_inputs, drawn with numpy. Tolerances are that file's: H and g
rtol 1e-4, atol 1e-3; stats rtol 1e-4, atol 1e-2. K8: indices equal,
distances rtol 1e-6. The CUDA kernels themselves are held to the twins in
tests/test_torch_icp_kernel_cuda.py and in chip_smoke.py, on the card.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from graphslam_tpu.ops.correspondence import nearest_neighbors_reference as jnn_reference
from graphslam_tpu.ops.icp_kernel import fused_icp_iteration as jfused
from graphslam_tpu.ops.icp_kernel import fused_icp_iteration_reference as jfused_reference
from graphslam_tpu_torch.frontend import icp
from graphslam_tpu_torch.ops import correspondence, icp_kernel


def make_inputs(P=256, Q=384, seed=0):
    """tests/test_icp_kernel.py::make_inputs, drawn with numpy."""
    rng = np.random.default_rng(seed)
    f = np.float32
    moved = rng.normal(size=(P, 2)).astype(f)
    jtheta = rng.normal(size=(P, 2)).astype(f)
    src_mask = rng.random(P) < 0.9
    tgt = rng.normal(size=(Q, 2)).astype(f)
    tgt_valid = rng.random(Q) < 0.85
    A = (rng.normal(size=(Q, 2, 2)) * 0.3).astype(f)
    Ct = (np.einsum("qij,qkj->qik", A, A) + 0.1 * np.eye(2)).astype(f)
    Csr = (np.abs(rng.normal(size=(P, 3))) * np.array([1.0, 0.1, 1.0])).astype(f)
    return moved, jtheta, src_mask, tgt, tgt_valid, Ct, Csr


def _check(ours, ref):
    (H, g, s), (jH, jg, js) = ours, ref
    np.testing.assert_allclose(H.numpy(), np.asarray(jH), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(g.numpy(), np.asarray(jg), rtol=1e-4, atol=1e-3)
    np.testing.assert_allclose(s.numpy(), np.asarray(js), rtol=1e-4, atol=1e-2)


CASES = {
    "aligned": (dict(P=256, Q=384, seed=0), 1.5),
    "unaligned_P": (dict(P=200, Q=256, seed=1), 1.0),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_icp_iteration_twin_matches_jax_reference(case):
    kw, max_corr2 = CASES[case]
    args = make_inputs(**kw)
    ours = icp_kernel.fused_icp_iteration(*(torch.from_numpy(a) for a in args),
                                          max_corr2=max_corr2, eps=1e-6)
    _check(ours, jfused_reference(*(jnp.asarray(a) for a in args), max_corr2=max_corr2, eps=1e-6))


def test_icp_iteration_twin_matches_jax_kernel_interpret():
    args = make_inputs()
    ours = icp_kernel.fused_icp_iteration(*(torch.from_numpy(a) for a in args),
                                          max_corr2=1.5, eps=1e-6)
    _check(ours, jfused(*(jnp.asarray(a) for a in args), max_corr2=1.5, eps=1e-6, interpret=True))


def test_icp_iteration_no_valid_targets():
    moved, jtheta, src_mask, tgt, _, Ct, Csr = make_inputs(seed=2)
    args = (moved, jtheta, src_mask, tgt, np.zeros(tgt.shape[0], bool), Ct, Csr)
    ours = icp_kernel.fused_icp_iteration(*(torch.from_numpy(a) for a in args),
                                          max_corr2=1.0, eps=1e-6)
    _check(ours, jfused_reference(*(jnp.asarray(a) for a in args), max_corr2=1.0, eps=1e-6))
    H, _, s = ours
    assert float(s[2]) == 0.0 and torch.all(H == 0)
    assert float(s[0]) == pytest.approx(1e9 * src_mask.sum(), rel=1e-6)


def test_rotated_covs_is_r_c_rt():
    rng = np.random.default_rng(5)
    A = rng.normal(size=(9, 2, 2))
    C = np.einsum("nij,nkj->nik", A, A).astype(np.float32)
    th = torch.tensor(0.7)
    R = torch.tensor([[np.cos(0.7), -np.sin(0.7)], [np.sin(0.7), np.cos(0.7)]], dtype=torch.float32)
    full = R @ torch.from_numpy(C) @ R.T
    got = icp_kernel.rotated_covs(icp_kernel._packed(torch.from_numpy(C)), th)
    np.testing.assert_allclose(got.numpy(), icp_kernel._packed(full).numpy(), atol=1e-5)


@pytest.mark.parametrize("case", ["cpu_tensors", "zero_iterations"])
def test_icp_loop_refuses_what_the_kernel_cannot_run(case):
    """fused_icp_loop has no CPU mode (gicp_match runs its plain loop there)
    and needs at least one iteration."""
    moved, _, src_mask, tgt, tgt_valid, _, _ = make_inputs(seed=3)
    t = [torch.from_numpy(a) for a in (moved, src_mask, tgt, tgt_valid)]
    Cs = icp.surfel_covs(t[0], t[1], 4, 1e-3)
    Ct = icp.surfel_covs(t[2], t[3], 4, 1e-3)
    iterations, match = (6, "CUDA") if case == "cpu_tensors" else (0, "iterations")
    before = icp_kernel.fused_icp_loop.launches
    with pytest.raises(ValueError, match=match):
        icp_kernel.fused_icp_loop(t[0], t[1], t[2], t[3], Cs, Ct, torch.zeros(3), iterations,
                                  1.25**2, 1e-6, 1e-5)
    assert icp_kernel.fused_icp_loop.launches == before


@pytest.mark.parametrize("case", ["random", "ties", "no_valid"])
def test_nearest_neighbors_twin_matches_jax(case):
    rng = np.random.default_rng(7)
    src = rng.normal(size=(200, 2)).astype(np.float32)
    tgt = rng.normal(size=(300, 2)).astype(np.float32)
    valid = rng.random(300) < 0.8
    if case == "ties":
        tgt = np.round(tgt * 2) / 2          # many equal distances
        src = np.round(src * 2) / 2
    elif case == "no_valid":
        valid[:] = False
    idx, d2 = correspondence.nearest_neighbors(
        torch.from_numpy(src), torch.from_numpy(tgt), torch.from_numpy(valid))
    jidx, jd2 = jnn_reference(jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(valid))
    assert idx.dtype == torch.int32
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(d2.numpy(), np.asarray(jd2), rtol=1e-6)
    if case == "no_valid":
        assert torch.all(idx == 0) and torch.all(torch.isinf(d2))


def test_wrappers_reject_non_cuda_non_cpu_inputs():
    args = [torch.from_numpy(a) for a in make_inputs(P=8, Q=8)]
    meta = [a.to("meta") for a in args]
    with pytest.raises(ValueError, match="CUDA"):
        icp_kernel.fused_icp_iteration(*meta, max_corr2=1.0, eps=1e-6)
    with pytest.raises(ValueError, match="CPU or CUDA"):
        correspondence.nearest_neighbors(meta[0], meta[3], meta[4])
