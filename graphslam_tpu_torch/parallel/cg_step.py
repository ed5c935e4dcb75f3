"""The three kernels of a distributed SE(2) GN iteration (K6a-c), hand-written in CUDA.

Port of graphslam_tpu/parallel/cg_step.py. Each rank of a mesh runs, per GN
iteration of parallel/dist_fused.py's kernel path:

  stage_a   (K6a, replaces `stage_a` :291)  the odometry chain linearized
            and weighted by w_chain = [rank == 0], so that the all-reduce
            counts it exactly once; this rank's loop edges linearized
            (Huber if huber_delta > 0) and summed onto their nodes. Out:
            the payload [D (N,3,3); U (N,3,3); g (N,3)] that one all-reduce
            combines, and the per-edge Aij stash for the CG matvec.
  gn_setup  (K6b, replaces `gn_setup` :400)  the reduced payload plus the
            priors, Marquardt damping D_ii (1 + lam), the K-level PCR factor
            of the chain (ridge eps = 3e-4 at every level), b = -g.
  cg_step   (K6c, replaces `cg_step` :438)  one guarded CG iteration:
            alpha = rz / (s0 + s1), x += alpha p, r -= alpha (chain_Ap +
            tile_Ap), z = PCR^-1 r, beta, p = z + beta p, chain_Ap = (D + U
            + L) p with s0 = p.chain_Ap (replicated), and this rank's loop
            H p with s1 = p.tile_Ap (the partial that one all-reduce of
            [tile_Ap; s1] combines). The first pass, from the zero state,
            is the CG prologue (alpha = beta = 0 exactly).

The CUDA source is csrc/cg_step.cu (plain C interface, built with nvcc by
ops/_build.py, called through ctypes); its SE(2) and PCR device code is the
fused GN kernel's, shared through csrc/se2_blocks.cuh. K6a, K6b and K6c
are each one launch of a persistent kernel on a thread-block cluster (a
cluster barrier where the staged sequences `stage_a_staged`,
`gn_setup_staged` and `cg_step_staged`, 2, 1 + K and K + 4 launches, have a
kernel boundary, bitwise equal to them; kept for checks and timings only);
K6c is called on the carry that `CgStepKernel.cg_state` allocated and
checked once a solve. The TPU layout
(sublane-packed (8, L) planes, the tall (3Q, 128) layout, one-hot MXU
gathers, hi/lo bf16 splits, 1024-node padding, edge tiles) is not carried
over: tensors are node-major (N, 3) and (N, 3, 3), loop edges gathered by
index and summed onto nodes through a CSR of this rank's live edges, in edge
order (no float atomics). The tile partition of the JAX code survives only
in which rank owns which edge (parallel/dist_fused.py).

Each kernel has its plain torch twin (`stage_a_reference`,
`gn_setup_reference`, `cg_step_reference`). The wrappers `stage_a`,
`gn_setup` and `cg_step` take the twin only for tensors on the CPU; for
CUDA tensors they launch the kernel or raise, and count their launches.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import NamedTuple, Optional, Tuple

import torch

from graphslam_tpu_torch.geometry import se2
from graphslam_tpu_torch.ops import gn_kernel as gk
from graphslam_tpu_torch.ops.pcg_kernel import _shift_blocks, pcr_apply_reference


@dataclasses.dataclass
class Shard:
    """One rank's problem: the whole chain and the priors (replicated), this
    rank's loop edges and their CSR, K PCR levels, and w_chain (1 on rank
    0, 0 elsewhere). Masked edges have zero z and sqrt-information and stay
    out of the CSR."""

    N: int
    c: int
    K: int
    w_chain: float
    huber_delta: float
    chain_z: torch.Tensor    # (c, 3)
    chain_R: torch.Tensor    # (c, 3, 3)
    prior_z: torch.Tensor    # (N, 3)
    prior_R: torch.Tensor    # (N, 3, 3)
    loop_i: torch.Tensor     # (El,) int32
    loop_j: torch.Tensor     # (El,) int32
    loop_z: torch.Tensor     # (El, 3)
    loop_R: torch.Tensor     # (El, 3, 3)
    loop_mask: torch.Tensor  # (El,) bool
    csr_ptr: torch.Tensor    # (N+1,) int32
    csr_ent: torch.Tensor    # (2 El,) int32
    _kernel: Optional["CgStepKernel"] = None

    T = 3  # tangent dimension; the SE(3) Shard6 (parallel/cg_step6.py) sets 6
    linearize = staticmethod(gk._linearize_rows)  # whitened (rw, Jiw, Jjw) of edges

    @property
    def El(self) -> int:
        return self.loop_i.shape[0]

    @property
    def device(self) -> torch.device:
        return self.prior_z.device

    def kernel(self) -> "CgStepKernel":
        """The rank's problem on the card (built at first use)."""
        if self._kernel is None:
            self._kernel = CgStepKernel(self)
        return self._kernel


def make_shard(pk: gk.PackedGraph, lo: int, hi: int, K: int, w_chain: float,
               huber_delta: float, cls=Shard) -> Shard:
    """The Shard (or `cls`, its SE(3) subclass with a PackedGraph6) of a
    packed graph whose loop edges [lo, hi) this rank owns."""
    li, lj = pk.loop_i[lo:hi].contiguous(), pk.loop_j[lo:hi].contiguous()
    live = pk.loop_mask[lo:hi]
    ptr, ent = gk.edge_csr(li, lj, live, pk.N)
    return cls(
        N=pk.N, c=pk.c, K=K, w_chain=float(w_chain), huber_delta=float(huber_delta),
        chain_z=pk.chain_z, chain_R=pk.chain_R, prior_z=pk.prior_z, prior_R=pk.prior_R,
        loop_i=li, loop_j=lj, loop_z=pk.loop_z[lo:hi].contiguous(),
        loop_R=pk.loop_R[lo:hi].contiguous(), loop_mask=live.contiguous(),
        csr_ptr=ptr, csr_ent=ent,
    )


class Setup(NamedTuple):
    """K6b's (and K7b's) output: damped diagonal blocks D and chain blocks U
    (N,T,T), the PCR factor A, G (K,N,T,T) and Dinv (N,T,T), and b = -g
    (N,T)."""

    D: torch.Tensor
    U: torch.Tensor
    A: torch.Tensor
    G: torch.Tensor
    Dinv: torch.Tensor
    b: torch.Tensor


class CgState(NamedTuple):
    """The CG carry, updated in place by each cg_step: x, r, p and chain_Ap
    (N,T), scal (4,) = [rz, s0, -, -], and big (TN+1,) = [tile_Ap; s1],
    all-reduced between passes."""

    x: torch.Tensor
    r: torch.Tensor
    p: torch.Tensor
    cap: torch.Tensor
    scal: torch.Tensor
    big: torch.Tensor


def cg_state(b: torch.Tensor) -> CgState:
    """The zero carry with r = b: the first cg_step is the CG prologue."""
    z = torch.zeros_like(b)
    return CgState(x=z, r=b.clone(), p=torch.zeros_like(b), cap=torch.zeros_like(b),
                   scal=torch.zeros(4, dtype=b.dtype, device=b.device),
                   big=torch.zeros(b.numel() + 1, dtype=b.dtype, device=b.device))


def new_carry(sh: Shard, b: torch.Tensor) -> CgState:
    """The zero carry of a solve: `cg_state` for CPU tensors, the rank's
    kernel's own (checked once, then passed by recorded pointers) for CUDA
    tensors."""
    if b.device.type == "cpu":
        return cg_state(b)
    return sh.kernel().cg_state(b)


def payload_size(N: int, T: int = 3) -> int:
    """Floats of stage_a's payload: D (T^2 N), U (T^2 N), g (TN)."""
    return (2 * T + 1) * T * N


def unpack_payload(payload: torch.Tensor, N: int, T: int = 3):
    """(D (N,T,T), U (N,T,T), g (N,T)) views of a payload."""
    M = T * T * N
    return (payload[:M].view(N, T, T), payload[M: 2 * M].view(N, T, T),
            payload[2 * M: 2 * M + T * N].view(N, T))


# ---------------------------------------------------------------------------
# Plain twins
# ---------------------------------------------------------------------------


def _node_sum(sh: Shard, vi: torch.Tensor, vj: torch.Tensor) -> torch.Tensor:
    """Per-node sums of this rank's live loop-edge terms, vi[l] onto node
    loop_i[l] and vj[l] onto loop_j[l], each node's terms added in the CSR's
    order (edge l ascending, the i end before the j end)."""
    El, N = sh.El, sh.N
    shape = tuple(vi.shape[1:])
    vals = torch.stack([vi, vj], 1).reshape((2 * El,) + shape)
    node = torch.stack([sh.loop_i, sh.loop_j], 1).reshape(-1).long()
    node = torch.where(sh.loop_mask.repeat_interleave(2), node, N)
    out = torch.zeros((N + 1,) + shape, dtype=vi.dtype, device=vi.device)
    return out.index_put_((node,), vals, accumulate=True)[:N]


def chain_blocks(poses: torch.Tensor, sh: Shard, lo: int = 0, hi: Optional[int] = None):
    """(D, U, g) of the chain edges n = lo..hi-1 (n -> n+1) alone, on N
    nodes: D[n] = Aii[n] + Ajj[n-1], U[n] = Aij[n], g likewise."""
    N, c, T = sh.N, sh.c, sh.T
    hi = c if hi is None else min(hi, c)
    D = torch.zeros((N, T, T), dtype=poses.dtype, device=poses.device)
    U = torch.zeros_like(D)
    g = torch.zeros((N, T), dtype=poses.dtype, device=poses.device)
    if hi > lo:
        rw, Jiw, Jjw = sh.linearize(poses[lo:hi], poses[lo + 1: hi + 1],
                                    sh.chain_z[lo:hi], sh.chain_R[lo:hi], -1.0)
        Aii, Aij, Ajj, gi, gj = gk._outer(Jiw, Jjw, rw)
        D[lo:hi] += Aii
        D[lo + 1: hi + 1] += Ajj
        g[lo:hi] += gi
        g[lo + 1: hi + 1] += gj
        U[lo:hi] = Aij
    return D, U, g


def loop_blocks(poses: torch.Tensor, sh: Shard):
    """(D, g) sums of this rank's loop edges on their nodes, and the
    per-edge Aij (El,T,T)."""
    li, lj = sh.loop_i.long(), sh.loop_j.long()
    rw, Jiw, Jjw = sh.linearize(poses[li], poses[lj], sh.loop_z, sh.loop_R, sh.huber_delta)
    Aii, Aij, Ajj, gi, gj = gk._outer(Jiw, Jjw, rw)
    return _node_sum(sh, Aii, Ajj), _node_sum(sh, gi, gj), Aij


def stage_a_reference(sh: Shard, poses: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain twin of K6a (and K7a): (payload ((2T+1)TN,), Aij (El,T,T))."""
    D, U, g = chain_blocks(poses, sh)
    Dl, gl, Aij = loop_blocks(poses, sh)
    w = sh.w_chain
    payload = torch.cat([(D * w + Dl).reshape(-1), (U * w).reshape(-1), (g * w + gl).reshape(-1)])
    return payload, Aij


def prior_blocks(poses: torch.Tensor, sh: Shard):
    """(Ap (N,3,3), gp (N,3)) of the per-node priors: r = Log(z^-1 x),
    J = Jr^-1(r), zero where a node has none."""
    rp = gk._log(gk._between(sh.prior_z, poses))
    Jpw = gk._mm(sh.prior_R, se2.right_jacobian_inv(rp))
    rpw = gk._mv(sh.prior_R, rp)
    JpT = Jpw.transpose(-1, -2)
    return gk._mm(JpT, Jpw), gk._mv(JpT, rpw)


def gn_setup_reference(sh: Shard, payload: torch.Tensor, poses: torch.Tensor,
                       lam: torch.Tensor) -> Setup:
    """Plain twin of K6b on the all-reduced payload; lam is a (1,) tensor."""
    D, U, g = unpack_payload(payload, sh.N)
    Ap, gp = prior_blocks(poses, sh)
    D = gk._damp(D + Ap, lam[0])
    A, G, Dinv = gk.pcr_factor_reference(D, U, sh.K)
    return Setup(D=D, U=U.clone(), A=A, G=G, Dinv=Dinv, b=-(g + gp))


def chain_hvp(D: torch.Tensor, U: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """(D + U + L) v of the chain system, L[n] = U[n-1]^T."""
    L = _shift_blocks(U.transpose(-1, -2), 1)
    return gk._mv(D, v) + gk._mv(U, _shift_blocks(v, -1)) + gk._mv(L, _shift_blocks(v, 1))


def loop_hvp(sh: Shard, Aij: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """This rank's loop part of H v: Aij v_j onto i, Aij^T v_i onto j."""
    li, lj = sh.loop_i.long(), sh.loop_j.long()
    return _node_sum(sh, gk._mv(Aij, v[lj]), gk._mv(Aij.transpose(-1, -2), v[li]))


def cg_step_reference(sh: Shard, st: Setup, Aij: torch.Tensor, cs: CgState) -> None:
    """Plain twin of K6c (and K7c): one pass on the carry `cs`, in place;
    cs.big then holds this rank's [tile_Ap; s1] partial."""
    N, T = cs.x.shape
    tiny = torch.tensor(gk._TINY, dtype=cs.x.dtype, device=cs.x.device)
    zero = torch.zeros((), dtype=cs.x.dtype, device=cs.x.device)
    rz, s0, s1 = cs.scal[0], cs.scal[1], cs.big[T * N]
    tile_ap = cs.big[: T * N].view(N, T)
    pHp = s0 + s1
    alpha = torch.where(pHp > tiny, rz / torch.maximum(pHp, tiny), zero)
    x = cs.x + alpha * cs.p
    r = cs.r - alpha * (cs.cap + tile_ap)
    z = pcr_apply_reference(st.A, st.G, st.Dinv, r)
    rz_new = torch.sum(r * z)
    beta = torch.where(rz > tiny, rz_new / torch.maximum(rz, tiny), zero)
    p = z + beta * cs.p
    cap = chain_hvp(st.D, st.U, p)
    tile = loop_hvp(sh, Aij, p)
    cs.x.copy_(x)
    cs.r.copy_(r)
    cs.p.copy_(p)
    cs.cap.copy_(cap)
    cs.scal[0] = rz_new
    cs.scal[1] = torch.sum(p * cap)
    cs.big[: T * N] = tile.reshape(-1)
    cs.big[T * N] = torch.sum(p * tile)


# ---------------------------------------------------------------------------
# The CUDA kernels (csrc/cg_step.cu) through ctypes
# ---------------------------------------------------------------------------


class _Problem(ctypes.Structure):
    """Mirror of `struct CgProblem` in csrc/cg_step.cu and of `struct
    Cg6Problem` in csrc/cg_step6.cu (same field order, R the sqrt-
    information; checked against the C side's <prefix>_problem_size() at
    load)."""

    _fields_ = [(f, ctypes.c_void_p) for f in (
        "poses", "cz", "cR", "pz", "pR", "li", "lj", "lz", "lR", "csr_ptr", "csr_ent",
        "payload", "Aij", "D", "A", "G", "Dinv", "b", "ws", "stream",
    )] + [(f, ctypes.c_int) for f in ("N", "c", "El", "K")] + [
        (f, ctypes.c_float) for f in ("eps", "huber_delta", "w_chain")
    ]


def _lib(name: str = "cg_step", prefix: str = "cg") -> ctypes.CDLL:
    from graphslam_tpu_torch.ops import _build

    lib = _build.load(name)
    P = ctypes.POINTER(_Problem)
    vp = ctypes.c_void_p
    for fn, args in (("stage_a", [P]), ("gn_setup", [P, vp]), ("step", [P] + [vp] * 6),
                     ("stage_a_staged", [P]), ("gn_setup_staged", [P, vp]),
                     ("step_staged", [P] + [vp] * 6)):
        if hasattr(lib, f"{prefix}_{fn}"):
            getattr(lib, f"{prefix}_{fn}").argtypes = args
            getattr(lib, f"{prefix}_{fn}").restype = ctypes.c_int
    for fn, args, res in (("ws_floats", [ctypes.c_int] * 4, ctypes.c_longlong),
                          ("problem_size", [], ctypes.c_int),
                          ("error_string", [ctypes.c_int], ctypes.c_char_p)):
        getattr(lib, f"{prefix}_{fn}").argtypes = args
        getattr(lib, f"{prefix}_{fn}").restype = res
    size = getattr(lib, f"{prefix}_problem_size")()
    if size != ctypes.sizeof(_Problem):
        raise RuntimeError(
            f"the problem struct is {size} bytes in csrc/{name}.cu but "
            f"{ctypes.sizeof(_Problem)} in its ctypes mirror: the fields differ")
    return lib


class CgStepKernel:
    """One rank's Shard on the card with K6's buffers: the payload (21N,),
    the Aij stash (El,3,3) and the Setup tensors, each written in place by
    the launch that produces it, and the CG carry of the current solve
    (`cg_state`). CgStep6Kernel (parallel/cg_step6.py) is the same over
    SE(3) poses (P = 12 entries) and 6x6 blocks."""

    T, P, NAME, PREFIX = 3, 3, "cg_step", "cg"

    def __init__(self, sh: Shard):
        dev = sh.device
        if dev.type != "cuda":
            raise ValueError(f"{type(self).__name__} needs CUDA tensors, got {dev}")
        N, c, El, K, T, P = sh.N, sh.c, sh.El, sh.K, self.T, self.P
        for label, t, shape in (
            ("chain z", sh.chain_z, (c, P)), ("chain R", sh.chain_R, (c, T, T)),
            ("prior z", sh.prior_z, (N, P)), ("prior R", sh.prior_R, (N, T, T)),
            ("loop z", sh.loop_z, (El, P)), ("loop R", sh.loop_R, (El, T, T)),
        ):
            gk._check_f32(label, t, shape, dev)
            if not t.is_contiguous():
                raise ValueError(f"{label} is not contiguous")
        # the kernels index by these without bounds checks
        li, lj = sh.loop_i, sh.loop_j
        torch._assert_async(((li >= 0) & (li < N) & (lj >= 0) & (lj < N)).all())
        self.lib, self.sh, self.device = _lib(self.NAME, self.PREFIX), sh, dev
        f32 = dict(dtype=torch.float32, device=dev)
        self.payload = torch.empty(payload_size(N, T), **f32)
        self.Aij = torch.empty((El, T, T), **f32)
        self.setup = Setup(D=torch.empty((N, T, T), **f32),
                           U=unpack_payload(self.payload, N, T)[1],
                           A=torch.empty((K, N, T, T), **f32), G=torch.empty((K, N, T, T), **f32),
                           Dinv=torch.empty((N, T, T), **f32), b=torch.empty((N, T), **f32))
        self.ws = torch.empty(int(self._fn("ws_floats")(N, c, El, K)), **f32)
        s = self.setup
        self.prob = _Problem(
            None, *(t.data_ptr() for t in (
                sh.chain_z, sh.chain_R, sh.prior_z, sh.prior_R, li, lj, sh.loop_z, sh.loop_R,
                sh.csr_ptr, sh.csr_ent, self.payload, self.Aij, s.D, s.A, s.G, s.Dinv, s.b,
                self.ws)),
            None, N, c, El, K, gk._EPS, sh.huber_delta, sh.w_chain,
        )
        self.carry: Optional[CgState] = None
        self._step = self._fn("step")
        self._step_args: tuple = ()

    def _fn(self, fn: str):
        return getattr(self.lib, f"{self.PREFIX}_{fn}")

    def _call(self, fn: str, *args) -> None:
        self.prob.stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._fn(fn)(ctypes.byref(self.prob), *args)
        if rc != 0:
            raise RuntimeError(f"{self.PREFIX}_{fn} failed: CUDA error {rc} "
                               f"({self._fn('error_string')(rc).decode()})")

    def stage_a(self, poses: torch.Tensor):
        return self._stage_a("stage_a", poses)

    def stage_a_staged(self, poses: torch.Tensor):
        """K6a or K7a as its staged sequence (`cg_stage_a_staged`,
        `cg6_stage_a_staged`: 2 launches): the yardstick of checks and
        timings, never on the path."""
        return self._stage_a("stage_a_staged", poses)

    def _stage_a(self, fn: str, poses: torch.Tensor):
        gk._check_f32("poses", poses, (self.sh.N, self.P), self.device)
        poses = poses.contiguous()
        self.prob.poses = poses.data_ptr()
        self._call(fn)
        return self.payload, self.Aij

    def gn_setup(self, payload: torch.Tensor, poses: torch.Tensor, lam: torch.Tensor) -> Setup:
        return self._setup("gn_setup", payload, poses, lam)

    def gn_setup_staged(self, payload: torch.Tensor, poses: torch.Tensor,
                        lam: torch.Tensor) -> Setup:
        """K6b or K7b as its staged sequence (`cg_gn_setup_staged`,
        `cg6_gn_setup_staged`: 1 + K launches): the yardstick of checks and
        timings, never on the path."""
        return self._setup("gn_setup_staged", payload, poses, lam)

    def _setup(self, fn: str, payload: torch.Tensor, poses: torch.Tensor,
               lam: torch.Tensor) -> Setup:
        N = self.sh.N
        gk._check_f32("payload", payload, (payload_size(N, self.T),), self.device)
        gk._check_f32("lam", lam, (1,), self.device)
        gk._check_f32("poses", poses, (N, self.P), self.device)
        poses = poses.contiguous()
        if payload.data_ptr() != self.payload.data_ptr():
            self.payload.copy_(payload)
        self.prob.poses = poses.data_ptr()
        self._call(fn, lam.data_ptr())
        return self.setup

    def cg_state(self, b: torch.Tensor) -> CgState:
        """A new zero carry with r = b (N,T), checked once here: the
        kernel's carry until the next cg_state, which cg_step then takes by
        the pointers recorded now."""
        gk._check_f32("b", b, (self.sh.N, self.T), self.device)
        carry = cg_state(b.contiguous())
        self.carry = carry
        self._step_args = (ctypes.byref(self.prob),) + tuple(t.data_ptr() for t in carry)
        return carry

    def _own(self, fn: str, Aij: torch.Tensor, cs: CgState) -> None:
        if Aij.data_ptr() != self.Aij.data_ptr():
            raise ValueError(f"{fn} takes the Aij stash of this kernel's own stage_a")
        if cs is not self.carry:
            raise ValueError(f"{fn} takes the carry of this kernel's latest cg_state")

    def cg_step(self, Aij: torch.Tensor, cs: CgState) -> None:
        """One CG pass (K6c, K7c) on the carry, in place: one ctypes call of
        the persistent kernel on the pointers cg_state recorded."""
        self._own("cg_step", Aij, cs)
        self.prob.stream = torch.cuda.current_stream(self.device).cuda_stream
        rc = self._step(*self._step_args)
        if rc != 0:
            raise RuntimeError(f"{self.PREFIX}_step failed: CUDA error {rc} "
                               f"({self._fn('error_string')(rc).decode()})")

    def cg_step_staged(self, Aij: torch.Tensor, cs: CgState) -> None:
        """The same pass as the staged sequence (`cg_step_staged`,
        `cg6_step_staged`: K + 4 launches): the yardstick of checks and
        timings, never on the path."""
        self._own("cg_step_staged", Aij, cs)
        self._call("step_staged", *self._step_args[1:])


def stage_a(sh: Shard, poses: torch.Tensor):
    """K6a: (payload (21N,), Aij (El,3,3)) of this rank. CPU tensors take the
    twin; CUDA tensors the kernel (the returned tensors are its buffers,
    overwritten by its next launch)."""
    if poses.device.type == "cpu":
        return stage_a_reference(sh, poses)
    out = sh.kernel().stage_a(poses)
    stage_a.launches += 1
    return out


def gn_setup(sh: Shard, payload: torch.Tensor, poses: torch.Tensor, lam: torch.Tensor) -> Setup:
    """K6b on the all-reduced payload; lam is a (1,) tensor on the device."""
    if poses.device.type == "cpu":
        return gn_setup_reference(sh, payload, poses, lam)
    out = sh.kernel().gn_setup(payload, poses, lam)
    gn_setup.launches += 1
    return out


def cg_step(sh: Shard, st: Setup, Aij: torch.Tensor, cs: CgState) -> None:
    """K6c: one CG pass on the carry cs, in place."""
    if cs.x.device.type == "cpu":
        return cg_step_reference(sh, st, Aij, cs)
    kern = sh.kernel()
    if st.D.data_ptr() != kern.setup.D.data_ptr():
        raise ValueError("cg_step takes the Setup of this rank's own gn_setup")
    kern.cg_step(Aij, cs)
    cg_step.launches += 1


stage_a.launches = 0
gn_setup.launches = 0
cg_step.launches = 0
