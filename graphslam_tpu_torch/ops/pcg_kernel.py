"""Parallel cyclic reduction (PCR) and the fused whole-CG-loop kernel (K3).

Port of graphslam_tpu/ops/pcg_kernel.py. `pcr_factor` and
`pcr_apply_reference` are the plain PCR: unlike the folding cyclic
reduction in solver/tridiag.py, PCR keeps every row in place and eliminates
neighbours at doubling distances h = 2^k; each step is two shifted block
products.

`fused_pcg_solve` (mode "pcg_fused", the inner solve of solver/lm.py's
_lm_loop) replaces the Pallas kernel pcg_kernel.py::_kernel: exact PCR
(K = ceil(log2 N)) with the fused GN kernel's ridge and adjugate inverse,
then a fixed count of guarded CG iterations on an assembled SE(2)
BlockSystem. For CUDA tensors it runs `gn_pcg` of csrc/gn_kernel.cu on a D
damped here in torch, as the JAX package damps in XLA: the fused GN
kernel's PCR and CG stages (ops/gn_kernel.py), all of them in ONE launch of
a persistent kernel on a thread-block cluster, with a cluster barrier where
the staged sequence (`gn_factor` then `gn_cg`, 401 launches at m3500) has a
kernel boundary, and bitwise equal to it. For CPU tensors it runs its plain
twin `fused_pcg_solve_reference`. Loop edges whose block is all zero
(masked slots of the online graph) add exactly zero to H@v and are left out
of the kernel's CSR.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch


def _shift_blocks(X: torch.Tensor, s: int) -> torch.Tensor:
    """result[i] = X[i-s] with zero fill at both ends (s may be negative)."""
    if s == 0:
        return X
    Y = torch.zeros_like(X)
    n = X.shape[0]
    if abs(s) >= n:
        return Y
    if s > 0:
        Y[s:] = X[: n - s]
    else:
        Y[: n + s] = X[-s:]
    return Y


def pcr_levels_for(n: int, levels: Optional[int]) -> int:
    """ceil(log2 n) elimination levels, truncated to `levels` when given."""
    K = max(1, math.ceil(math.log2(max(n, 2))))
    if levels is not None:
        K = min(K, max(1, levels))
    return K


def pcr_factor(
    D: torch.Tensor, U: torch.Tensor, eps: float = 3e-4, levels: Optional[int] = None
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """PCR elimination coefficients for the block-tridiagonal (D, U).

    D (n, T, T): diagonal blocks. U (n, T, T): U[i] couples rows i and i+1
    (zero at i >= n_real-1). `levels` truncates the elimination to distance
    2^levels (None = exact).

    Returns (A, G, Dinv): A[k], G[k] are the step-k coefficients
    (alpha_i = L_i Dinv_{i-h}, gamma_i = U_i Dinv_{i+h}, h = 2^k) and Dinv the
    final diagonal inverse. The rhs recursion
        b_i <- b_i - A[k]_i b_{i-h} - G[k]_i b_{i+h}
    followed by x = Dinv b solves (D, U) x = b (exactly when not truncated).

    Ridge and inverse are the XLA ones (solver/tridiag.py::_regularize and
    solver/normal_eq.py::_block_inv), not the fused GN kernel's.
    """
    from graphslam_tpu_torch.solver.normal_eq import _block_inv
    from graphslam_tpu_torch.solver.tridiag import _regularize

    K = pcr_levels_for(D.shape[0], levels)
    L = _shift_blocks(U.transpose(-1, -2), 1)  # L[i] = U[i-1]^T
    A_steps, G_steps = [], []
    for k in range(K):
        h = 1 << k
        D = _regularize(D, eps)
        Dinv = _block_inv(D)
        alpha = torch.einsum("nij,njk->nik", L, _shift_blocks(Dinv, h))
        gamma = torch.einsum("nij,njk->nik", U, _shift_blocks(Dinv, -h))
        A_steps.append(alpha)
        G_steps.append(gamma)
        D = (
            D
            - torch.einsum("nij,njk->nik", alpha, _shift_blocks(U, h))
            - torch.einsum("nij,njk->nik", gamma, _shift_blocks(L, -h))
        )
        L = -torch.einsum("nij,njk->nik", alpha, _shift_blocks(L, h))
        U = -torch.einsum("nij,njk->nik", gamma, _shift_blocks(U, -h))
    Dinv = _block_inv(_regularize(D, eps))
    return torch.stack(A_steps), torch.stack(G_steps), Dinv


def pcr_apply_reference(A, G, Dinv, b):
    """Plain PCR solve: b (n, T) -> x (n, T)."""
    for k in range(A.shape[0]):
        h = 1 << k
        b = (
            b
            - torch.einsum("nij,nj->ni", A[k], _shift_blocks(b, h))
            - torch.einsum("nij,nj->ni", G[k], _shift_blocks(b, -h))
        )
    return torch.einsum("nij,nj->ni", Dinv, b)


# ---------------------------------------------------------------------------
# K3: the fused PCR-preconditioned CG (graphslam_tpu pcg_kernel.py:399)
# ---------------------------------------------------------------------------


class _Loops(NamedTuple):
    """The loop-edge view that ops/gn_kernel.py's hvp_reference reads."""

    loop_i: torch.Tensor
    loop_j: torch.Tensor
    El: int


def _chain_and_loops(sys, lam, lm_diag_scaling: bool, chain_prefix: int, T: int = 3):
    """(damped D, chain U, b, loop i, loop j, loop blocks) of a BlockSystem
    of T x T blocks: U[k] = Aij[k] for the chain edges k < c =
    min(chain_prefix, N-1), which couple (k, k+1); every later edge is a
    loop edge. Raises unless the system's blocks are T x T."""
    from graphslam_tpu_torch.solver.normal_eq import _damped_diag

    N, Tg = sys.g.shape
    if Tg != T:
        raise ValueError(f"expected a BlockSystem of T={T} blocks, got T={Tg}")
    c = min(chain_prefix, N - 1)
    U = torch.zeros((N, T, T), dtype=sys.g.dtype, device=sys.g.device)
    U[:c] = sys.Aij[:c]
    D = _damped_diag(sys, lam, lm_diag_scaling)
    li = sys.edges[c:, 0].to(torch.int32).contiguous()
    lj = sys.edges[c:, 1].to(torch.int32).contiguous()
    return D, U, -sys.g, li, lj, sys.Aij[c:]


def fused_pcg_solve_reference(sys, lam, max_iters: int = 25, lm_diag_scaling: bool = True,
                              chain_prefix: int = 0) -> torch.Tensor:
    """Plain torch twin of K3, same arguments and result dx (N, 3): exact
    PCR with the fused GN kernel's ridge and inverse
    (ops/gn_kernel.py::pcr_factor_reference), then `cg_reference`."""
    from graphslam_tpu_torch.ops import gn_kernel as gk

    D, U, b, li, lj, A = _chain_and_loops(sys, lam, lm_diag_scaling, chain_prefix)
    sysm = gk.GnSystem(D=D, U=U, b=b, Aij_loop=A)
    factor = gk.pcr_factor_reference(D, U, pcr_levels_for(D.shape[0], None))
    return gk.cg_reference(sysm, _Loops(li, lj, li.shape[0]), factor, max_iters)


def live_loops(A: torch.Tensor) -> torch.Tensor:
    """Loop edges whose (E, 3, 3) block is not all zero: K3's CSR holds
    only these."""
    return A.flatten(1).ne(0).any(1)


def fused_pcg_solve(sys, lam, max_iters: int = 25, lm_diag_scaling: bool = True,
                    chain_prefix: int = 0) -> torch.Tensor:
    """Drop-in for pcg_solve(..., preconditioner="tridiag") with a fixed
    iteration count and exact PCR: dx (N, 3) of (H + damping) dx = -g for an
    SE(2) BlockSystem whose first chain_prefix edges are (k, k+1).

    CUDA tensors go through K3 (`PcgKernel`), CPU tensors through
    `fused_pcg_solve_reference`."""
    if sys.g.device.type == "cpu":
        return fused_pcg_solve_reference(sys, lam, max_iters, lm_diag_scaling, chain_prefix)
    x = PcgKernel(*_chain_and_loops(sys, lam, lm_diag_scaling, chain_prefix), max_iters).solve()
    fused_pcg_solve.launches += 1
    return x


fused_pcg_solve.launches = 0


class PcgKernel:
    """K3's problem on the card (csrc/gn_kernel.cu `gn_pcg`) with its
    buffers: exact-K PCR of the chain system (D (N,T,T) damped, U (N,T,T)),
    then max_iters cold guarded CG iterations with the loop blocks A
    (El,T,T) of edges (li, lj), on b (N,T). `solve` launches it and returns
    x (N,T); `staged` runs the same solve as the fused GN kernel's factor
    and CG entries, one launch per stage (K3's yardstick). No host read:
    the edge ids are checked on the device (`torch._assert_async`). Raises
    for tensors not on a CUDA device. T = 3 here;
    ops/pcg6_kernel.py::Pcg6Kernel is K5 at T = 6 (`gn6_pcg`, one launch,
    and its staged launches in csrc/gn6_kernel.cu)."""

    @staticmethod
    def fused():
        """The fused GN kernel's wrapper class whose library runs this CG."""
        from graphslam_tpu_torch.ops import gn_kernel as gk

        return gk.GnKernel

    def __init__(self, D, U, b, li, lj, A, max_iters: int):
        from graphslam_tpu_torch.ops import gn_kernel as gk

        F = self.fused()
        N, dev, T = D.shape[0], D.device, F.T
        if dev.type != "cuda":
            raise ValueError(f"{type(self).__name__} needs CUDA tensors, got {dev}")
        if max_iters < 0:
            raise ValueError(f"max_iters {max_iters} < 0")
        El = li.shape[0]
        for name, t, shape in (("D", D, (N, T, T)), ("U", U, (N, T, T)), ("b", b, (N, T)),
                               ("Aij", A, (El, T, T))):
            gk._check_f32(name, t, shape, dev)
        for name, t in (("li", li), ("lj", lj)):
            if t.device != dev or t.dtype != torch.int32 or tuple(t.shape) != (El,):
                raise ValueError(f"{name}: expected int32 ({El},) on {dev}, got "
                                 f"{t.dtype} {tuple(t.shape)} on {t.device}")
        # the kernel indexes by these without bounds checks
        torch._assert_async(((li >= 0) & (li < N) & (lj >= 0) & (lj < N)).all())
        self.gk, self.fn = gk, f"{F.PREFIX}_pcg"
        self.lib, self.device, self.max_iters = F.load(), dev, int(max_iters)
        self.ptr, self.ent = gk.edge_csr(li, lj, live_loops(A), N)
        self.bufs = tuple(t.contiguous() for t in (D, U, b, A, li, lj))
        D, U, b, A, li, lj = self.bufs
        self.x = torch.empty((N, T), dtype=torch.float32, device=dev)
        K = pcr_levels_for(N, None)
        n_ws = getattr(self.lib, f"{F.PREFIX}_ws_floats")(N, 0, El, K, self.max_iters)
        self.ws = torch.empty(int(n_ws), dtype=torch.float32, device=dev)
        self.prob = F.Problem(
            None, None, None, None, None, li.data_ptr(), lj.data_ptr(), None, None,
            self.ptr.data_ptr(), self.ent.data_ptr(), D.data_ptr(), U.data_ptr(), b.data_ptr(),
            self.x.data_ptr(), self.ws.data_ptr(), A.data_ptr(), None, None,
            N, 0, El, K, self.max_iters, gk._EPS, -1.0,
        )

    def solve(self) -> torch.Tensor:
        self.gk.call(self.lib, self.prob, self.device, self.fn, self.max_iters)
        return self.x

    def staged(self) -> torch.Tensor:
        """The same solve through the `factor` and cold `cg` entries."""
        prefix = self.fn.rsplit("_", 1)[0]
        self.gk.call(self.lib, self.prob, self.device, f"{prefix}_factor")
        self.gk.call(self.lib, self.prob, self.device, f"{prefix}_cg", self.max_iters, 0)
        return self.x
