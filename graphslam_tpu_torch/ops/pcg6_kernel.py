"""The fused SE(3) PCR-preconditioned CG (K5).

Port of graphslam_tpu/ops/pcg6_kernel.py::fused_pcg6_solve (mode
"pcg_fused" on SE(3) graphs, the inner solve of solver/lm.py's _lm_loop):
exact PCR (K = ceil(log2 N)) of the chain part with the fused SE(3)
kernel's ridge and 6x6 inverse, then a fixed count of guarded CG iterations
on an assembled T=6 BlockSystem. For CUDA tensors it runs `gn6_pcg` of
csrc/gn6_kernel.cu on a D damped here in torch, as the JAX package damps
in XLA: K4's wide PCR factor and CG stages (ops/gn6_kernel.py; a group of
6 threads a 6x6 row), all of them in ONE launch of a persistent kernel
(one thread-block cluster at garage), with a barrier where the staged
sequence (`gn6_factor` then `gn6_cg`, 347 launches at garage) has a kernel
boundary, and bitwise equal to it. For CPU tensors it runs its plain twin
`fused_pcg6_solve_reference`. Loop edges whose block is all zero (masked
slots) add exactly zero to H@v and are left out of the kernel's CSR.
"""

from __future__ import annotations

import torch

from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops import gn6_kernel as g6
from graphslam_tpu_torch.ops.pcg_kernel import (
    PcgKernel, _chain_and_loops, _Loops, pcr_levels_for,
)


def fused_pcg6_solve_reference(sys, lam, max_iters: int = 25, lm_diag_scaling: bool = True,
                               chain_prefix: int = 0) -> torch.Tensor:
    """Plain torch twin of K5, same arguments and result dx (N, 6): exact
    PCR with K4's ridge and inverse (ops/gn6_kernel.py::pcr_factor_reference6),
    then ops/gn_kernel.py::cg_reference."""
    D, U, b, li, lj, A = _chain_and_loops(sys, lam, lm_diag_scaling, chain_prefix, T=6)
    sysm = gk.GnSystem(D=D, U=U, b=b, Aij_loop=A)
    factor = g6.pcr_factor_reference6(D, U, pcr_levels_for(D.shape[0], None))
    return gk.cg_reference(sysm, _Loops(li, lj, li.shape[0]), factor, max_iters)


def fused_pcg6_solve(sys, lam, max_iters: int = 25, lm_diag_scaling: bool = True,
                     chain_prefix: int = 0) -> torch.Tensor:
    """SE(3) drop-in for pcg_solve(..., preconditioner="tridiag") with a
    fixed iteration count and exact PCR (graphslam_tpu pcg6_kernel.py:316):
    dx (N, 6) of (H + damping) dx = -g for a T=6 BlockSystem whose first
    chain_prefix edges are (k, k+1).

    CUDA tensors go through K5 (`Pcg6Kernel`), CPU tensors through
    `fused_pcg6_solve_reference`."""
    if sys.g.device.type == "cpu":
        return fused_pcg6_solve_reference(sys, lam, max_iters, lm_diag_scaling, chain_prefix)
    args = _chain_and_loops(sys, lam, lm_diag_scaling, chain_prefix, T=6)
    x = Pcg6Kernel(*args, max_iters).solve()
    fused_pcg6_solve.launches += 1
    return x


fused_pcg6_solve.launches = 0


class Pcg6Kernel(PcgKernel):
    """K5's problem on the card (csrc/gn6_kernel.cu `gn6_pcg`, one launch):
    ops/pcg_kernel.py::PcgKernel at T = 6, with D, U (N,6,6), b (N,6) and
    the loop blocks A (El,6,6); `solve` returns x (N,6), `staged` the same
    x through gn6_factor + gn6_cg."""

    @staticmethod
    def fused():
        return g6.Gn6Kernel
