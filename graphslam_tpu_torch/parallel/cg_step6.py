"""The three kernels of a distributed SE(3) GN iteration (K7a-c), hand-written in CUDA.

Port of graphslam_tpu/parallel/cg_step6.py: parallel/cg_step.py's K6a-c
with SE(3) poses (N, 12) and 6x6 blocks. Each rank of a mesh runs, per GN
iteration of parallel/dist_fused6.py's kernel path:

  stage_a6   (K7a, replaces `stage_a6` :210)  the odometry chain linearized
             and weighted by w_chain = [rank == 0], so that the all-reduce
             counts it exactly once; this rank's loop edges linearized
             (Huber if huber_delta > 0) and summed onto their nodes. Out:
             the payload [D (N,6,6); U (N,6,6); g (N,6)] (78N floats) that
             one all-reduce combines, and the per-edge Aij stash.
  gn_setup6  (K7b, replaces `gn_setup6` :313)  the reduced payload plus the
             priors (one per node, as ops/gn6_kernel.py::pack_graph6 packs
             them), Marquardt damping D_ii (1 + lam) on the 6 diagonal
             entries, the K-level PCR factor of the chain (ridge eps = 3e-4
             at every level), b = -g.
  cg_step6   (K7c, replaces `cg_step6` :456)  one guarded CG iteration, the
             same as K6c: alpha = rz / (s0 + s1), x and r updated, z = PCR^-1
             r, beta, p = z + beta p, chain_Ap = (D + U + L) p with s0 =
             p.chain_Ap, and this rank's loop H p with s1 = p.tile_Ap (the
             partial [tile_Ap; s1] of 6N + 1 floats that one all-reduce
             combines). The first pass, from the zero state, is the CG
             prologue (alpha = beta = 0 exactly).

The CUDA source is csrc/cg_step6.cu (plain C interface, built with nvcc by
ops/_build.py, called through ctypes); its 6x6, SE(3) and PCR device code is
the fused SE(3) kernel's, shared through csrc/se3_blocks.cuh. K7a, K7b
and K7c are each ONE launch of a persistent kernel: K7a one thread a row
on narrow CTAs (K6a's design), K7b and K7c on K4's wide stages (a group of
6 threads a 6x6 row), each on one cluster or a cooperative grid; their
staged sequences stay as `CgStep6Kernel.stage_a_staged`,
`gn_setup_staged` and `cg_step_staged`, bitwise equal, for checks and
timings only. The TPU layout
((8, L) planes, 6x6 blocks as 36 plane groups, the tall (42Q, 128) scatter,
one-hot MXU gathers, hi/lo bf16 splits, 1024-node padding with a circular
roll) is not carried over: tensors are node-major, loop edges gathered by
index and summed onto nodes through a CSR of this rank's live edges, in
edge order (no float atomics).

The twins and the CG carry are parallel/cg_step.py's, which work at T = 6:
`stage_a6_reference` and `cg_step6_reference` are its plain stages on a
Shard6; `gn_setup6_reference` adds the SE(3) priors and the 6x6 PCR. The
wrappers `stage_a6`, `gn_setup6` and `cg_step6` take the twin only for
tensors on the CPU; for CUDA tensors they launch the kernel or raise, and
count their launches.
"""

from __future__ import annotations

import dataclasses

import torch

from graphslam_tpu_torch.geometry import se3
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops import gn6_kernel as g6
from graphslam_tpu_torch.parallel import cg_step as cs
from graphslam_tpu_torch.parallel.cg_step import CgState, Setup, cg_state  # noqa: F401


@dataclasses.dataclass
class Shard6(cs.Shard):
    """One rank's SE(3) problem, the fields of cg_step.Shard: chain_z (c,12),
    chain_R (c,6,6) the sqrt-information, prior_z (N,12), prior_R (N,6,6),
    loop_z (El,12), loop_R (El,6,6). Masked edges and missing priors carry
    the identity measurement and a zero sqrt-information, and masked loop
    edges stay out of the CSR."""

    T = 6
    linearize = staticmethod(g6._linearize_rows6)

    def kernel(self) -> "CgStep6Kernel":
        """The rank's problem on the card (built at first use)."""
        if self._kernel is None:
            self._kernel = CgStep6Kernel(self)
        return self._kernel


def make_shard6(pk: g6.PackedGraph6, lo: int, hi: int, K: int, w_chain: float,
                huber_delta: float) -> Shard6:
    """The Shard6 of a packed SE(3) graph whose loop edges [lo, hi) this
    rank owns."""
    return cs.make_shard(pk, lo, hi, K, w_chain, huber_delta, cls=Shard6)


def payload_size6(N: int) -> int:
    """Floats of stage_a6's payload: D (36N), U (36N), g (6N)."""
    return cs.payload_size(N, 6)


def unpack_payload6(payload: torch.Tensor, N: int):
    """(D (N,6,6), U (N,6,6), g (N,6)) views of a payload."""
    return cs.unpack_payload(payload, N, 6)


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def stage_a6_reference(sh: Shard6, poses: torch.Tensor):
    """Plain twin of K7a: (payload (78N,), Aij (El,6,6))."""
    return cs.stage_a_reference(sh, poses)


def prior_blocks6(poses: torch.Tensor, sh: Shard6):
    """(Ap (N,6,6), gp (N,6)) of the per-node priors: r = Log(z^-1 x),
    J = Jr^-1(r), zero where a node has none (cg_step6.py:262-273)."""
    rp = se3.log(se3.between(sh.prior_z, poses))
    Jpw = g6._mm(sh.prior_R, se3.right_jacobian_inv(rp))
    JpT = Jpw.transpose(-1, -2)
    return g6._mm(JpT, Jpw), g6._mv(JpT, g6._mv(sh.prior_R, rp))


def gn_setup6_reference(sh: Shard6, payload: torch.Tensor, poses: torch.Tensor,
                        lam: torch.Tensor) -> Setup:
    """Plain twin of K7b on the all-reduced payload; lam is a (1,) tensor."""
    D, U, g = unpack_payload6(payload, sh.N)
    Ap, gp = prior_blocks6(poses, sh)
    D = gk._damp(D + Ap, lam[0])
    A, G, Dinv = g6.pcr_factor_reference6(D, U, sh.K)
    return Setup(D=D, U=U.clone(), A=A, G=G, Dinv=Dinv, b=-(g + gp))


def cg_step6_reference(sh: Shard6, st: Setup, Aij: torch.Tensor, carry: CgState) -> None:
    """Plain twin of K7c: one pass on the carry, in place; carry.big then
    holds this rank's [tile_Ap; s1] partial (6N + 1 floats)."""
    cs.cg_step_reference(sh, st, Aij, carry)


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/cg_step6.cu) through ctypes
# ---------------------------------------------------------------------------


class CgStep6Kernel(cs.CgStepKernel):
    """One rank's Shard6 on the card with K7's buffers: the payload (78N,),
    the Aij stash (El,6,6) and the Setup tensors, each written in place by
    the launch that produces it. stage_a, gn_setup and cg_step are one
    launch each; the *_staged methods are their staged sequences."""

    T, P, NAME, PREFIX = 6, 12, "cg_step6", "cg6"


def stage_a6(sh: Shard6, poses: torch.Tensor):
    """K7a: (payload (78N,), Aij (El,6,6)) of this rank. CPU tensors take
    the twin; CUDA tensors the kernel (the returned tensors are its buffers,
    overwritten by its next launch)."""
    if poses.device.type == "cpu":
        return stage_a6_reference(sh, poses)
    out = sh.kernel().stage_a(poses)
    stage_a6.launches += 1
    return out


def gn_setup6(sh: Shard6, payload: torch.Tensor, poses: torch.Tensor,
              lam: torch.Tensor) -> Setup:
    """K7b on the all-reduced payload; lam is a (1,) tensor on the device."""
    if poses.device.type == "cpu":
        return gn_setup6_reference(sh, payload, poses, lam)
    out = sh.kernel().gn_setup(payload, poses, lam)
    gn_setup6.launches += 1
    return out


def cg_step6(sh: Shard6, st: Setup, Aij: torch.Tensor, carry: CgState) -> None:
    """K7c: one CG pass on the carry, in place."""
    if carry.x.device.type == "cpu":
        return cg_step6_reference(sh, st, Aij, carry)
    kern = sh.kernel()
    if st.D.data_ptr() != kern.setup.D.data_ptr():
        raise ValueError("cg_step6 takes the Setup of this rank's own gn_setup6")
    kern.cg_step(Aij, carry)
    cg_step6.launches += 1


stage_a6.launches = 0
gn_setup6.launches = 0
cg_step6.launches = 0
