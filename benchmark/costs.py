"""The least time the card could take for a fused solve: frozen cost arithmetic.

Copied from chip_smoke.py (`_bound`, `gn_cost`, `lm_cost`, `gn6_cost` and
the peaks) so that a roofline share read by this benchmark keeps its
meaning while the program changes. Each function counts the bytes (inputs
read once, poses written once) and the float32 operations of one solve
from the algorithm's stages at the cell's shapes, whatever implements it.
"""

from __future__ import annotations

import math

# One NVIDIA H100 SXM (data sheet, at its 700 W limit): HBM3 bytes a second
# and dense float32 operations a second outside the tensor cores.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


def bound_ms(nbytes: float, flops: float) -> float:
    """Bytes over the memory rate or operations over the peak rate,
    whichever is longer, in ms."""
    return 1e3 * max(nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S)


def pcr_levels(N: int, levels) -> int:
    """The PCR levels a solve runs: `levels`, or the full ceil(log2 N)."""
    return int(levels) if levels is not None else math.ceil(math.log2(N))


def gn_cost(N: int, c: int, El: int, K: int, iters: int, cg: int):
    """One fused SE(2) GN solve: (bytes, operations)."""
    nbytes = 12 * N + 48 * c + 48 + 56 * El + 12 * N
    per_cg = N * (54 + 36 * K + 18 + 10) + 72 * El  # H@p, K-level PCR apply, Dinv, dots
    per_gn = (250 * (c + El) + 60 * N      # linearize + assemble
              + 400 * K * N                # PCR factor
              + (cg + 1) * per_cg          # CG, with its initial residual
              + 40 * N)                    # retract
    return nbytes, iters * per_gn


def lm_cost(N: int, c: int, El: int, K: int, iters: int, cg: int):
    """One fused SE(2) LM solve: a GN solve's stages plus, per iteration,
    the damping, the candidate's cost pass over every chain, loop and prior
    row (~120 operations each) and the accept step."""
    nbytes, flops = gn_cost(N, c, El, K, iters, cg)
    per_it = 3 * N + 120 * (c + El + N) + 3 * N
    return nbytes + 16, flops + (iters + 1) * per_it


def gn6_cost(N: int, c: int, El: int, K: int, iters: int, cg: int):
    """One fused SE(3) GN solve: ~3500 operations to linearize an edge,
    ~1500 to assemble a node with its prior, ~2400 per node and PCR level,
    ~250 to retract, and the CG's H@p, PCR apply, Dinv and dots."""
    nbytes = 4 * (12 * N + 48 * c + 48 * N + 2 * El + 48 * El + 12 * N)
    per_cg = N * (72 + 144 + 144 * K + 72 + 30) + 144 * El
    per_gn = 3500 * (c + El) + 1500 * N + 2400 * K * N + (cg + 1) * per_cg + 250 * N
    return nbytes, iters * per_gn
