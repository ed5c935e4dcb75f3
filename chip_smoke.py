#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphslam_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

It builds csrc/gn_kernel.cu with nvcc, holds the fused GN kernel against its
plain torch twin stage by stage, drives the m3500 Gauss-Newton solve through
graphslam_tpu_torch.solver.lm._gn_loop(mode="gn_fused") as bench.py drives
the JAX one, and times the kernel path and the plain path on the card.
Phases, each failing with a traceback and a nonzero exit:

  1. device info: card name and power limit (nvidia-smi), CUDA, nvcc, triton
  2. build the kernel from the checkout's sources
  3. kernel against plain twin on manhattan(260): assembled D and b after one
     linearization (rel 1e-5), one PCR apply (rel 1e-4), one CG solve
     (rel 1e-3), and 5 whole GN iterations (wrapped atol 2e-3) in the plain,
     exact-PCR, chain-only, masked, Huber and warm-start variants
  4. m3500 main path on cuda: ATE gate (< 0.35 m and < half the initial
     ATE), the kernel's launch count above 0, two runs bitwise equal, and
     5 iterations within wrapped atol 2e-3 of the plain twin
  5. m3500 GN it/s for the kernel path and the plain path on the card,
     median of 3 reps of back-to-back solves

Before the last line it prints one JSON object describing the kernel; the
last line is {"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, it exits nonzero and prints no result.
"""

import json
import math
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent

# Tolerances (float32 on both sides; the kernel sums in another order and
# contracts to FMAs, so only roundoff-level differences are expected):
TOL_ASSEMBLY_REL = 1e-5   # D and b after one linearization
TOL_PCR_REL = 1e-4        # K=4 levels of 3x3 products and inverses
TOL_CG_REL = 1e-3         # 25 CG iterations amplify roundoff
TOL_POSES_WRAPPED = 2e-3  # the repo's kernel-vs-XLA pose tolerance (GN)
ATE_GATE_M = 0.35         # bench.py's gate


def log(*a):
    print(*a, flush=True)


def fail(msg: str):
    raise RuntimeError(msg)


def wrapped_max(a, b) -> float:
    import torch

    d = (a - b).double()
    d[:, 2] = torch.remainder(d[:, 2] + math.pi, 2 * math.pi) - math.pi
    return float(d.abs().max())


def rel_err(a, b) -> float:
    return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120)


def phase_info(torch, utils):
    log("== phase 1: device")
    card = utils.device_info()
    log(card)
    log(f"torch {torch.__version__}, torch.version.cuda {torch.version.cuda}, "
        f"device count {torch.cuda.device_count()}, "
        f"device 0 {torch.cuda.get_device_name(0)}")
    from graphslam_tpu_torch.ops import _build

    nv = run([_build.nvcc(), "--version"])
    log("nvcc:", nv.stdout.strip().splitlines()[-1] if nv.returncode == 0 else nv.stderr)
    try:
        import triton  # noqa: F401
        log(f"triton {triton.__version__} imports")
    except ImportError as e:
        log(f"triton does not import: {e}")
    return card


def phase_build():
    log("== phase 2: build")
    from graphslam_tpu_torch.ops import _build

    t0 = time.perf_counter()
    lib, ptxas = _build.build("gn_kernel")
    log(f"built {lib.relative_to(ROOT)} in {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "spill" in line:
            log("  ptxas:", line.strip())


def _solve_pair(torch, gk, p0, g, **kw):
    out = gk.fused_gn_solve(p0, g, iterations=5, cg_iters=25, **kw)
    ref = gk.fused_gn_solve_reference(p0, g, iterations=5, cg_iters=25, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"kernel produced non-finite poses ({kw})")
    return wrapped_max(out, ref)


def phase_stages(torch, datasets, from_dataset, gk):
    log("== phase 3: kernel against plain twin, manhattan(260)")
    dev = torch.device("cuda")
    data = datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)
    g = from_dataset(data, device=dev)
    p0 = torch.from_numpy(data["poses"]).to(dev)

    kern = gk.GnKernel(p0, g, -1.0, 4, cg_max=25)
    kern.system()
    sysm = gk.system_reference(p0, kern.pk)
    torch.cuda.synchronize()
    for name, a, b, tol in (
        ("D", kern.D, sysm.D, TOL_ASSEMBLY_REL),
        ("b", kern.b, sysm.b, TOL_ASSEMBLY_REL),
        ("U", kern.U, sysm.U, TOL_ASSEMBLY_REL),
    ):
        e = rel_err(a, b)
        log(f"  assembled {name}: rel err {e:.3e} (tol {tol})")
        if not e <= tol:
            fail(f"assembled {name} differs from the plain twin: {e}")

    kern.factor()
    factor = gk.pcr_factor_reference(sysm.D, sysm.U, kern.K)
    gen = torch.Generator(device="cpu").manual_seed(0)
    v = torch.randn((p0.shape[0], 3), generator=gen).to(dev)
    e = rel_err(kern.precond(v), gk.pcr_apply_reference(*factor, v))
    log(f"  PCR apply (K={kern.K}): rel err {e:.3e} (tol {TOL_PCR_REL})")
    if not e <= TOL_PCR_REL:
        fail(f"PCR apply differs from the plain twin: {e}")

    kern.cg(25)
    x_ref = gk.cg_reference(sysm, kern.pk, factor, 25)
    torch.cuda.synchronize()
    e = rel_err(kern.x, x_ref)
    log(f"  CG solve (25 it): rel err {e:.3e} (tol {TOL_CG_REL})")
    if not e <= TOL_CG_REL:
        fail(f"CG solve differs from the plain twin: {e}")

    chain = datasets.manhattan(n_poses=150, loop_prob=0.0, seed=0)
    g_chain = from_dataset(chain, device=dev)
    p_chain = torch.from_numpy(chain["poses"]).to(dev)
    E, c = g.num_edges, g.chain_prefix
    mask = g.edge_mask.clone()
    mask[E - 1] = False
    mask[c - 2] = False
    variants = (
        ("pcr_levels=4", p0, g, dict(pcr_levels=4)),
        ("exact PCR", p0, g, dict(pcr_levels=None)),
        ("chain-only", p_chain, g_chain, dict(pcr_levels=4)),
        ("masked", p0, g.replace(edge_mask=mask), dict(pcr_levels=4)),
        ("Huber 1.0", p0, g, dict(pcr_levels=4, huber_delta=1.0)),
        ("warm + ramp", p0, g, dict(pcr_levels=4, warm_start=True, cg_ramp=((3, 25), (2, 12)))),
    )
    for name, p, gg, kw in variants:
        e = _solve_pair(torch, gk, p, gg, **kw)
        log(f"  5 GN iterations, {name}: wrapped max err {e:.3e} (tol {TOL_POSES_WRAPPED})")
        if not e <= TOL_POSES_WRAPPED:
            fail(f"5-iteration solve ({name}) differs from the plain twin: {e}")


def phase_main(torch, datasets, from_dataset, chi2, metrics, lm, cfg, gk):
    log("== phase 4: m3500 main path on cuda")
    dev = torch.device("cuda")
    data = datasets.m3500()
    g = from_dataset(data, device=dev)
    p0 = torch.from_numpy(data["poses"]).to(dev)
    gt = torch.from_numpy(data["gt"]).to(dev)
    iters = 50

    gk.fused_gn_solve.launches = 0
    out = lm._gn_loop(p0, g, cfg, "gn_fused", iters)
    out2 = lm._gn_loop(p0, g, cfg, "gn_fused", iters)
    torch.cuda.synchronize()
    launches = gk.fused_gn_solve.launches
    log(f"  fused_gn_solve launches in the main path: {launches}")
    if launches <= 0:
        fail("the main path did not launch the kernel")
    if not torch.isfinite(out).all():
        fail("m3500 poses are not finite")
    ate0, ate = float(metrics.ate(p0, gt)), float(metrics.ate(out, gt))
    log(f"  m3500: chi2 {float(chi2(p0, g)):.1f} -> {float(chi2(out, g)):.1f} in {iters} "
        f"GN iters; ATE {ate0:.4f} -> {ate:.4f}")
    if not (ate < ATE_GATE_M and ate < 0.5 * ate0):
        fail(f"ATE gate failed: {ate0} -> {ate}")
    if not torch.equal(out, out2):
        fail(f"two runs differ: max {float((out - out2).abs().max())}")
    log("  two runs bitwise equal")

    err = _solve_pair(torch, gk, p0, g, pcr_levels=cfg.pcr_levels)
    log(f"  m3500 5 GN iterations kernel vs plain: wrapped max err {err:.3e} "
        f"(tol {TOL_POSES_WRAPPED})")
    if not err <= TOL_POSES_WRAPPED:
        fail(f"m3500 kernel differs from the plain twin: {err}")
    return p0, g, launches, err


def _time_solves(torch, solve, p0, reps: int, chain: int) -> float:
    """Median seconds of `chain` back-to-back solves (each fed the previous
    output), over `reps` reps, each ending in torch.cuda.synchronize."""
    p = solve(p0)
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        p = p0
        for _ in range(chain):
            p = solve(p)
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def phase_timing(torch, gk, cfg, card, p0, g):
    log("== phase 5: m3500 timing")
    iters = 50

    def kernel(p):
        return gk.fused_gn_solve(p, g, iterations=iters, cg_iters=cfg.cg_max_iterations,
                                 pcr_levels=cfg.pcr_levels)

    def plain(p):
        return gk.fused_gn_solve_reference(p, g, iterations=iters,
                                           cg_iters=cfg.cg_max_iterations,
                                           pcr_levels=cfg.pcr_levels)

    chain_k, chain_p = 10, 2
    t_plain_a = _time_solves(torch, plain, p0, 3, chain_p)
    t_kern = _time_solves(torch, kernel, p0, 3, chain_k)
    t_plain_b = _time_solves(torch, plain, p0, 3, chain_p)
    t_plain = min(t_plain_a, t_plain_b)
    ms_k = 1e3 * t_kern / chain_k
    ms_p = 1e3 * t_plain / chain_p
    log(f"  card: {card}")
    log(f"  kernel path: {ms_k:.3f} ms per {iters}-iteration solve, "
        f"{iters * 1e3 / ms_k:.1f} GN it/s")
    log(f"  plain torch path: {ms_p:.3f} ms per solve ({1e3 * t_plain_a / chain_p:.3f} "
        f"before, {1e3 * t_plain_b / chain_p:.3f} after), {iters * 1e3 / ms_p:.1f} GN it/s")
    return ms_k, ms_p


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; nothing was run",
              file=sys.stderr)
        return 2
    if not (ROOT / "graphslam_tpu_torch" / "__init__.py").exists():
        print(f"chip_smoke: graphslam_tpu_torch/ is not beside {__file__}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))

    import graphslam_tpu_torch
    from graphslam_tpu_torch import metrics, utils
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.factors import chi2, from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.solver import lm

    if Path(graphslam_tpu_torch.__file__).resolve().parent != ROOT / "graphslam_tpu_torch":
        fail(f"imported graphslam_tpu_torch from {graphslam_tpu_torch.__file__}, "
             f"not from {ROOT}")
    if "jax" in sys.modules:
        fail("the port imported jax")

    card = phase_info(torch, utils)
    phase_build()
    phase_stages(torch, datasets, from_dataset, gk)
    # bench.py's headline config; edge_tile and hvp_splits are TPU knobs
    # the port accepts and ignores.
    cfg = SolverConfig(mode="gn_fused", cg_max_iterations=25, cg_tol=1e-7, pcr_levels=4,
                       edge_tile=512, hvp_splits=1)
    p0, g, launches, err = phase_main(torch, datasets, from_dataset, chi2, metrics, lm, cfg, gk)
    ms_k, ms_p = phase_timing(torch, gk, cfg, card, p0, g)

    print(json.dumps({"kernels": [{
        "name": "gn_kernel",
        "route": "cuda",
        "source": "graphslam_tpu_torch/csrc/gn_kernel.cu",
        "replaces": "graphslam_tpu/ops/gn_kernel.py:600",
        "launches": launches,
        "max_abs_err": err,
        "ms": ms_k,
        "plain_ms": ms_p,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
