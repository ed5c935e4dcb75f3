#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (graphslam_tpu_torch) on one NVIDIA GPU.

Usage, from the root of a checkout:  python3 chip_smoke.py

It builds csrc/gn_kernel.cu, csrc/icp_kernel.cu, csrc/gn6_kernel.cu,
csrc/cg_step.cu and csrc/cg_step6.cu with nvcc (in parallel), holds every
kernel against its plain torch twin, drives the slices of the port (SE(2)
GN, the online pipeline, LM, SE(3), the distributed SE(2) and SE(3)
solvers) through the entry points a user calls, and times the kernel paths
and the plain paths on the card. Phases, each failing with a traceback and
a nonzero exit:

  1. device info: card name and power limit (nvidia-smi), CUDA, nvcc,
     triton; float32 matmuls at "highest" precision, TF32 off
  2. build the five kernel sources from the checkout
  3. fused GN kernel (K1) against its plain twin on manhattan(260):
     assembled D and b after one linearization (rel 1e-5), one PCR apply
     (rel 1e-4), one CG solve (rel 1e-3), and 5 whole GN iterations (wrapped
     atol 2e-3) in the plain, exact-PCR, chain-only, masked, Huber and
     warm-start variants; K1's gn_solve (one launch of a persistent
     kernel on a thread-block cluster) bitwise equal to its
     staged sequence gn_solve_staged on the chain-only, masked and warm +
     ramp inputs
  4. m3500 main path on cuda: ATE gate (< 0.35 m and < half the initial
     ATE), the kernel's launch count above 0, two runs bitwise equal, and
     5 iterations within wrapped atol 2e-3 of the plain twin; gn_solve
     bitwise equal to gn_solve_staged at m3500 (50 iterations) and at
     city10000 (16 CTAs walking 40 row blocks)
  5. m3500 GN it/s for the kernel path and the plain path on the card,
     median of 3 reps of back-to-back solves; gn_solve's C entry in turns
     with gn_solve_staged (CUDA events), host launch calls a solve
     (profiler: 1), ptxas registers and spills, the idle share of a solve
     through fused_gn_solve (profiler)
  6. frontend kernels against their twins on simulated scans: one GICP IRLS
     iteration (K2; H, g rtol 1e-4 atol 1e-3, stats rtol 1e-4 atol 1e-2)
     and the nearest valid target (K8; indices equal, distances rtol 1e-6;
     nn_search, a group of threads a point, bitwise equal to the
     one-thread-a-point nn_search_serial, distances by their bits)
     at full width (1152 points) and unaligned, and gicp_match through the
     kernel against the plain path on scan pairs of the tour (delta atol
     5e-3)
  7. the online pipeline's main path on cuda: the closed-loop replay of
     scripts/bench_all.py's frontend config (1024-keyframe capacity, 4 warm
     GN iterations at cg 12 in mode gn_fused, 1081 beams in 1152 points)
     over the first min(300, T) scans of simulate_trajectory(step_len=0.25,
     seed=1), made with the port's raycaster. Gate from the JAX package's
     replay of the same config (scripts/replay_gate_jax.py on the CPU):
     keyframes within 3, loops at least 2 fewer, replay ATE at most 0.02 m
     above it and below half the dead-reckoned ATE. The launch counts of K1
     and K2 above 0, and two replays bitwise equal. K1 against its twin at
     the replay's solve (the bucket of the final map, every pose with a
     prior, 1024 loop slots mostly masked, warm CG at cg 12, exact PCR;
     wrapped atol 2e-3), and each step up to 20 scans past the first loop
     commit through the kernels and through the plain twins on the card
     from the same state: decisions and factor counts equal, keyframe
     poses wrapped atol 2e-3; gn_solve bitwise equal to gn_solve_staged
     at the replay's solve (one CTA).
  8. timing: replay frames/s through the kernels (median of 3) in turns
     with the replay whose K2 runs its staged launches (icp_match_staged),
     the plain path on the card over the first 60 scans; the replay
     through icp_match (one launch a match) bitwise equal to the replay
     through icp_match_staged (every state field and step info); the K2
     IRLS rounds that ran over a replay (the sum of each match's ctrl[1])
     beside those the staged entry enqueues; K2's C entries in turns with
     their staged sequences, one round at full width (icp_iteration) and
     one match (icp_match), with host launch calls a match (profiler: 1)
     and ptxas registers and spills; gicp_match in turns through both
     entries; K8's C entry in turns with nn_search_serial (a call by CUDA
     events, and a launch from CUDA graph replays), against its twin and
     torch.cdist, host launch calls a call (profiler: 1), ptxas registers
     and spills; and one
     profiled replay (device busy share, kernels and host synchronizations
     per scan)
  9. LM kernels against their twins on manhattan(260): K1's LM mode, 5
     Huber iterations at pcr_levels 4 and exact (poses wrapped atol 3e-3,
     chi2 within 1%, accepted steps and converged equal; its cost pass
     alone rel 1e-5); K3 (the fused PCG) at lam 0 and 1e-3 (rel 1e-3); 5
     iterations of _lm_loop(pcg_fused) through K3 against the same loop
     through the twin (wrapped atol 3e-3); K3 on the replay's online graph
     at bucket 128 (rel 1e-3, its CSR holding only the live loop slots);
     K3 (one persistent launch on a thread-block cluster) bitwise equal to
     the staged gn_factor + gn_cg it replaced, and two calls bitwise, at
     lam 0 and 1e-3 and on the online graph (and at m3500 in phase 10);
     K1's gn_lm_solve (one launch) bitwise equal to gn_lm_solve_staged,
     5 Huber steps at pcr_levels 4 and exact
 10. the m3500 LM main paths on cuda: lm_solve in mode gn_fused (K1-LM,
     50 steps, cg 25, Huber, pcr_levels 4: scripts/bench_all.py's LM
     config) and in mode pcg_fused (_lm_loop through K3, 50 iterations).
     Gates from the JAX package's CPU runs (scripts/lm_gate_jax.py): ATE
     < 0.35 m and within 0.02 m of JAX's, chi2 within 1%; both kernels'
     launch counts above 0; two runs each bitwise equal; K1-LM within
     wrapped 3e-3 of its twin over 5 steps, K3 within rel 1e-3 at m3500;
     gn_lm_solve bitwise equal to gn_lm_solve_staged at m3500 (50 Huber
     steps) and city10000 (5)
 11. LM timing: m3500 LM it/s through K1-LM, in turns with its twin on
     the card and with K1's GN mode; _lm_loop(pcg_fused) it/s; K3 per call
     (its C entry on a prepared problem, in turns with the staged gn_factor
     + gn_cg, and the whole wrapper) against its twin (CUDA events), and
     its launches a call (profiler: 1); gn_lm_solve's C entry in turns
     with gn_lm_solve_staged, its host launch calls a solve (1), ptxas
     registers and spills; launches per LM iteration by source and the
     idle share (profiler); host synchronizations per _lm_loop iteration
 12. SE(3) kernels against their twins (csrc/gn6_kernel.cu) on
     sphere(10, 10) and on garage: K4's assembled D, U and b after one
     linearization (rel 1e-5), one PCR apply (rel 1e-4), one CG solve (rel
     1e-3); 5 GN iterations in the exact-PCR, pcr_levels=4, chain-only,
     masked-edge and warm + ramp variants (max |d| over the 12 pose
     entries <= 5e-3, the repo's SE(3) kernel-vs-XLA tolerance); K4-LM, 5
     Huber steps (poses <= 8e-3, chi2 within 1%, accepted steps and
     converged equal, its cost pass alone rel 1e-5); K5 at lam 0 and 1e-3
     (rel 1e-3), and gn6_pcg (one launch) bitwise equal to gn6_factor +
     gn6_cg and to a second call; K4's gn6_solve and gn6_lm_solve (one
     launch, a group of 6 threads a 6x6 row) bitwise equal to their
     staged sequences on the chain-only, masked and warm + ramp inputs and
     5 Huber LM steps
 13. the SE(3) main paths on cuda, scripts/bench_all.py's configs:
     sphere2500 and garage through _gn_loop(mode="gn_fused") (K4, cg 25,
     exact PCR, 20 iterations), and garage through lm_solve in modes
     gn_fused (K4-LM) and pcg_fused (_lm_loop with K5), 20 steps, cg 25,
     Huber 1.0. Gates from the JAX package's XLA runs of the same solves
     on the CPU (scripts/se3_gate_jax.py): ATE < 0.2 m and within 0.02 m
     of JAX's, chi2 within 2%; each kernel's launch count above 0 in its
     own path; two runs each bitwise equal; sphere2500 5 GN iterations
     kernel vs twin <= 5e-3; gn6_solve bitwise equal to gn6_solve_staged
     at sphere2500 and garage (20 iterations), gn6_lm_solve to
     gn6_lm_solve_staged at garage (20 Huber steps)
 14. SE(3) timing: sphere2500 and garage GN it/s through K4 in turns with
     the twin on the card (median of 3 reps of back-to-back solves); garage
     LM it/s through K4-LM (in turns with its twin) and through
     _lm_loop(pcg_fused); K5 per call at garage (its C entry on a prepared
     problem, and the whole wrapper, each in turns with the staged
     gn6_factor + gn6_cg; host launch calls a call, 1; ptxas registers and
     spills) against its twin (CUDA events);
     gn6_solve (sphere2500, garage) and gn6_lm_solve (garage) C entries in
     turns with their staged sequences, host launch calls a solve (1),
     ptxas registers and spills; launches per iteration by source and the
     idle share (profiler) of sphere2500 GN and garage LM
 15. K6a-c (csrc/cg_step.cu) against their twins on manhattan(260) and
     m3500, without and with Huber, two ranks in one process (half the loop
     edges each, the chain on rank 0; the all-reduces summed here): the K6a
     payload and Aij (rel 5e-5), K6b's damped D and b (rel 5e-5) and PCR
     factor (rel 1e-4), the K6c state after 1 pass (rel 1e-4) and after 26
     (rel 1e-3), each on its own line; two K6 sequences bitwise equal; K6c
     (one persistent launch a pass) bitwise equal to cg_step_staged, the
     carry after 1 and 26 passes, without and with Huber; K6a and K6b (one
     persistent launch a call each) bitwise equal to stage_a_staged and
     gn_setup_staged and to themselves, both ranks' payloads, Aij and
     Setups, without Huber at lam 0, with Huber at lam 1e-3 and with a
     chain-only rank
 16. the distributed main paths on cuda, m3500, world size 1 over NCCL:
     dist_fused_gn_solve through K6, 200 iterations at scripts/bench_all.py
     :207-248's cell (cg 25, pcr_levels 4, edge_tile 512; no page windows),
     and dist_fused_lm_solve, 50 steps with Huber 1.0 (the K1-LM cell's
     settings), each with its K6 launch counts above 0, gated on the JAX
     package's CPU runs (scripts/dist_gate_jax.py, hvp_splits 1): ATE <
     0.35 m, below half the initial ATE and within 0.02 m of JAX's, chi2
     within 1%, LM accepted steps equal; two runs bitwise equal; the plain
     path on the card through the same gates; kernel vs plain path over 5
     iterations (GN wrapped 2e-3, LM 3e-3); dist_gn_solve (parallel/dist.py,
     pcg, cg 50, 10 iterations) through the same gate
 17. two gloo ranks on the one card (torch.multiprocessing, CUDA tensors):
     the kernel path on manhattan(1000) in tiles of 32 loop edges, 3 GN
     iterations and 3 LM steps, against world size 1 within 1e-5 of the
     largest coordinate, accepted steps equal
 18. distributed timing: dist_fused GN it/s through K6 in turns with K1
     (_gn_loop gn_fused, the same config) and with the plain path on the
     card; K6a, K6b and K6c per call and their twins (CUDA events); the C
     entries and the wrappers of K6a and K6b in turns with their staged
     sequences, host launch calls a call (profiler: 1), ptxas registers and
     spills of cg_stage_a_persistent and cg_gn_setup_persistent; K6c in
     turns with cg_step_staged and its launches a pass (profiler: 1); the
     all_reduce at world size 1; launches per GN iteration by source and
     the idle share (profiler), and the cg_step.cu launches an iteration
     from the wrappers' counts times their launches a call (1 + 1 + 26 =
     28)
 19. K7a-c (csrc/cg_step6.cu) against their twins as phase 15 holds K6, on
     sphere(10, 10) and the garage at exact PCR, without and with Huber,
     two ranks in one process, at phase 15's tolerances; two K7 sequences
     bitwise equal; K7b (gn_setup6) and K7c (cg_step6), one persistent
     launch a call each, bitwise equal to their staged sequences
     (gn_setup_staged, cg_step_staged): the Setup and the carry after 1 and
     26 passes, two ranks, without and with Huber; K7a (stage_a6), one
     launch a call, bitwise equal to stage_a_staged, both ranks' payloads
     and Aij, without and with Huber, and two calls alike (phase 22 also at
     sphere2500)
 20. the distributed SE(3) main paths on cuda, world size 1 over NCCL:
     sphere2500 and garage through dist_fused6_gn_solve (K7, 20 iterations
     at scripts/bench_all.py:251-283's cell: cg 25, edge_tile 256, exact
     PCR; no page windows) and the garage through dist_fused6_lm_solve (20
     steps, Huber 1.0), each with its K7 launch counts above 0, gated on the
     JAX package's CPU runs (scripts/dist6_gate_jax.py, hvp_splits 1): ATE
     < 0.2 m and within 0.02 m of JAX's, chi2 within 2%, LM accepted steps
     equal; two runs bitwise equal; over 5 iterations the kernel path
     against the plain path on the card and against K4 (max |d| 5e-3 GN,
     8e-3 LM, accepted steps equal)
 21. two gloo ranks on the one card (CUDA tensors): the SE(3) kernel path on
     the garage in tiles of 64 loop edges, 3 GN iterations and 3 LM steps,
     against world size 1 within 1e-5 of the largest coordinate, accepted
     steps equal
 22. distributed SE(3) timing at sphere2500: dist_fused6 GN it/s through K7
     in turns with K4 (_gn_loop gn_fused, the same config) and with the
     plain path on the card; K7a, K7b and K7c per call and their twins
     (CUDA events); the C entries of K7a, K7b and K7c in turns with their
     staged sequences (CUDA events), their CTAs, host launch calls a call
     (profiler: 1), ptxas registers and spills of cg6_stage_a_persistent,
     cg6_gn_setup_wide and cg6_step_wide; the all_reduce at world size 1;
     launches per GN iteration by source and the idle share (profiler),
     and the cg_step6.cu launches an iteration from the wrappers' counts
     times their launches a call (1 + 1 + 26 = 28)

Before the last line it prints one JSON object describing the kernels
(max_abs_err: gn_kernel the larger of its m3500 and replay-solve pose
errors, icp_kernel gicp_match's delta through the kernel against the plain
path, and its "ms" is one round's C entry, "ms_staged" the staged one's in
turns, "ms_match_entry" / "ms_gicp_match" a match's, the launches a match
and the replay's frames/s with K2 staged beside; nn_kernel the distances at
full width, redesigned: "ms" the C entry's a call by CUDA events around
back-to-back calls (the host's ctypes work included, as every row's "ms"),
"ms_staged" nn_search_serial's in turns, "ms_launch" and
"ms_launch_staged" a launch from CUDA graph replays (the device's time),
launches a call, the group and CTA widths, registers and spills;
gn_kernel_lm its largest pose
error against the twin, pcg_kernel its largest dx error against the twin,
and its "ms" is the C entry's, "ms_staged" the staged gn_factor + gn_cg's
in turns, "ms_wrapper" the whole fused_pcg_solve's;
gn6_kernel, gn6_kernel_lm and pcg6_kernel likewise from phases 12-14, with
"ms" per sphere2500 GN solve, per garage LM solve and per K5 C-entry call
(pcg6_kernel also "ms_staged" and "ms_wrapper_staged" in turns, launches a
call, registers and spills);
the rows redesigned as one launch a solve (gn_kernel, gn_kernel_lm,
gn6_kernel, gn6_kernel_lm; "redesigned": true, as for pcg_kernel and
cg_step_cg_step, one launch a call) add "ms_entry" (the C entry) and
"ms_staged" (its staged sequence, in turns), launches a solve of each,
the idle share and the ptxas registers and spills of the persistent
kernels;
cg_step_stage_a, cg_step_gn_setup and cg_step_cg_step (K6a-c) from phases
15-18: "max_abs_err" the largest relative error against the twin (K6c also
the two-rank check), "ms" per call of the wrapper (K6c's "ms_staged" that of
cg_step_staged in turns), "launches" the count in
the GN main path and "launches_lm" in the LM one; K6a and K6b,
redesigned as one launch a call, add "ms_entry" (the C entry),
"ms_staged" and "ms_wrapper_staged" (the staged sequence's, in turns), the
host launch calls a call of each, and the ptxas registers and spills;
cg_step6_stage_a,
cg_step6_gn_setup and cg_step6_cg_step (K7a-c) likewise from phases 19-22,
"launches" in the sphere2500 GN main path, "launches_garage" in the garage
one, "launches_lm" in the garage LM one, "ms" at sphere2500; K7a-c,
redesigned as one launch a call, add "ms_entry" (the C entry) and
"ms_staged" (its staged sequence's, in turns), the host launch calls a
call of each, the launch's CTAs and the ptxas registers and spills);
the last line is
{"ok": true, "device": {...}}. Without a CUDA device, or
without the package beside it, it exits nonzero and prints no result.
"""

import dataclasses
import json
import math
import re
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
TOL_K2 = ((1e-4, 1e-3), (1e-4, 1e-3), (1e-4, 1e-2))  # (rtol, atol) of H, g, stats
TOL_K8_D2_REL = 1e-6      # both sides round each product and the sum alike
TOL_MATCH_DELTA = 5e-3    # the repo's fused-vs-XLA gicp_match tolerance
TOL_LM_POSES = 3e-3       # the repo's kernel-vs-XLA pose tolerance (LM/Huber)
TOL_CHI2_REL = 1e-2       # chi2 against the twin and against JAX
TOL_COST_REL = 1e-5       # one cost pass: sums of squares in another order
LM_ATE_BAND_M = 0.02      # ATE within this of the JAX package's

# The JAX package's replay of the phase-7 config on the CPU
# (scripts/replay_gate_jax.py, jax 0.9.0): 278 scans.
JAX_REPLAY = {"keyframes": 110, "loops": 29, "ate": 0.060562863945961,
              "ate_dead_reckoned": 0.5801027417182922}

# The JAX package's m3500 LM + Huber runs on the CPU (scripts/lm_gate_jax.py):
# fused_lm_solve in interpret mode ("steps": accepted) and
# lm_solve(mode="pcg_fused") ("steps": iterations), jax 0.9.0.
JAX_LM = {
    "fused": {"chi2": 5530.16357421875, "steps": 50, "ate": 0.29736045002937317},
    "loop": {"chi2": 5531.26416015625, "steps": 50, "ate": 0.2907252013683319},
}

# The JAX package's SE(3) solves on the CPU (scripts/se3_gate_jax.py, the XLA
# path: mode "pcg", cg 25, cg_tol 0; jax 0.9.0). GN: 20 iterations, chi2
# without a robust kernel; LM: lm_solve, 20 iterations, Huber 1.0 on loops.
JAX_SE3 = {
    "sphere2500_gn": {"chi2": 15126.3515625, "ate": 0.18779927492141724},
    "garage_gn": {"chi2": 1629.3319091796875, "ate": 0.13828694820404053},
    "garage_lm": {"chi2": 1477.469482421875, "ate": 0.1361154317855835, "steps": 20},
}
# The JAX package's distributed m3500 solves on one CPU device
# (scripts/dist_gate_jax.py: the XLA loop, cg_kernel=False, no page-window
# bucketization; jax 0.9.0). gn/lm at the cell's hvp_splits 1 (bf16 loop
# gathers), gn_hs3/lm_hs3 at hvp_splits 3 (float32-faithful, as the port
# multiplies); dist_gn is parallel/dist.py at pcg, cg 50, 10 iterations.
JAX_DIST = {
    "gn": {"chi2": 5734.572265625, "ate": 0.15083514153957367},
    "gn_hs3": {"chi2": 5733.77587890625, "ate": 0.15051093697547913},
    "lm": {"chi2": 5525.9423828125, "ate": 0.297905296087265, "steps": 50},
    "lm_hs3": {"chi2": 5527.24169921875, "ate": 0.2979288399219513, "steps": 50},
    "dist_gn": {"chi2": 6397.5380859375, "ate": 0.3465941846370697},
}
# The JAX package's distributed SE(3) solves on one CPU device
# (scripts/dist6_gate_jax.py: the XLA loop, cg_kernel=False, no page-window
# bucketization; cg 25, edge_tile 256, exact PCR, 20 iterations; jax 0.9.0).
# *_gn and garage_lm at the cell's hvp_splits 1 (bf16 loop gathers), *_hs3 at
# hvp_splits 3 (float32-faithful, as the port multiplies); GN chi2 without a
# robust kernel, LM chi2 with Huber 1.0 on the loops.
JAX_DIST6 = {
    "sphere2500_gn": {"chi2": 15147.064453125, "ate": 0.19013607501983643},
    "sphere2500_gn_hs3": {"chi2": 15144.9326171875, "ate": 0.1898946762084961},
    "garage_gn": {"chi2": 1630.5450439453125, "ate": 0.13992086052894592},
    "garage_gn_hs3": {"chi2": 1630.15673828125, "ate": 0.13934338092803955},
    "garage_lm": {"chi2": 1477.664306640625, "ate": 0.13682299852371216, "steps": 20},
    "garage_lm_hs3": {"chi2": 1477.659423828125, "ate": 0.13640356063842773, "steps": 20},
}
TOL_KERNEL_PATH = 2e-4    # the JAX kernel path vs its XLA loop (tests/test_dist_fused.py:170)
# K6a/K6b against their twins on the card: float32 with FMAs against float32
# without. Under Huber at m3500 the floor-based angle wrap alone, rounded once
# as an FMA rounds it, moves b by 8.7e-6 of its largest entry (measured on
# the CPU); the card measured 1.67e-5 in all.
TOL_K6_ASSEMBLY_REL = 5e-5
TOL_MESH = 1e-5           # mesh-size invariance (tests/test_dist_fused.py:55, :188)
SE3_ATE_GATE_M = 0.2      # scripts/bench_all.py's sphere2500/garage gate
SE3_CHI2_REL = 2e-2       # chi2 against JAX's XLA run
TOL_SE3_POSES = 5e-3      # the repo's SE(3) kernel-vs-XLA tolerance (GN)
TOL_SE3_LM_POSES = 8e-3   # the same for LM with Huber

# H100 SXM peaks (HBM3 bandwidth, dense FP32 rate), for the bounds.
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12


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
    prec = torch.get_float32_matmul_precision()
    log(f"float32 matmul precision {prec!r}, TF32 matmul "
        f"{torch.backends.cuda.matmul.allow_tf32}, cuDNN {torch.backends.cudnn.allow_tf32}")
    if prec != "highest" or torch.backends.cuda.matmul.allow_tf32 or \
            torch.backends.cudnn.allow_tf32:
        fail("float32 products must run in full precision (no TF32)")
    return card


def phase_build():
    log("== phase 2: build")
    from graphslam_tpu_torch.ops import _build

    t0 = time.perf_counter()
    built = _build.build_all(["gn_kernel", "icp_kernel", "gn6_kernel", "cg_step", "cg_step6"])
    log(f"built {len(built)} kernel libraries in parallel in {time.perf_counter() - t0:.2f} s")
    for lib, ptxas in built.values():
        log(f"  {lib.relative_to(ROOT)}")
        for line in ptxas.splitlines():
            if "registers" in line or "spill" in line or "Compiling entry" in line:
                log("  ptxas:", line.strip())


def _solve_pair(torch, gk, p0, g, iterations=5, cg_iters=25, **kw):
    out = gk.fused_gn_solve(p0, g, iterations=iterations, cg_iters=cg_iters, **kw)
    ref = gk.fused_gn_solve_reference(p0, g, iterations=iterations, cg_iters=cg_iters, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out).all():
        fail(f"kernel produced non-finite poses ({kw})")
    return wrapped_max(out, ref)


# fused_lm_solve's schedule: lam0, lam_factor, lam_min, lam_max, abs_tol, rel_tol
LM_ARGS = (1e-5, 10.0, 1e-10, 1e7, 1e-9, 1e-6)


def _persistent_bitwise(torch, Kernel, p0, g, label, levels=4, huber=-1.0, phases=((5, 25),),
                        warm=False, lm_steps=0):
    """The persistent entry of K1 or K4 (gn_solve / gn_lm_solve, gn6_*: one
    launch) against its staged sequence on fresh problems of the same
    inputs: poses and x (GN) or poses and stats (LM) bitwise; fails where
    they differ."""
    runs = []
    for staged in (False, True):
        if lm_steps:
            k = Kernel(p0, g, huber, levels, cg_max=25, lm=True)
            (k.lm_solve_staged if staged else k.lm_solve)(lm_steps, 25, *LM_ARGS)
            runs.append((k.poses.clone(), k.stats.clone()))
        else:
            k = Kernel(p0, g, huber, levels, cg_max=max(cg for _, cg in phases))
            (k.solve_staged if staged else k.solve)(phases, warm)
            runs.append((k.poses.clone(), k.x.clone()))
    torch.cuda.synchronize()
    (a, ax), (b, bx) = runs
    same = torch.equal(a, b) and torch.equal(ax, bx)
    entry = f"{Kernel.PREFIX}_{'lm_' if lm_steps else ''}solve"
    log(f"  {label}: {entry} (one launch) vs {entry}_staged: "
        f"{'bitwise equal' if same else 'DIFFERENT'}")
    if not (same and torch.isfinite(a).all()):
        fail(f"{label}: {entry} differs from its staged sequence (max |d| "
             f"{float((a - b).abs().max()):.3e})")


def _ptxas(name: str, entry: str):
    """(registers, spill store bytes) of the kernel `entry` in the build log
    of csrc/<name>.cu (nvcc -Xptxas -v)."""
    from graphslam_tpu_torch.ops import _build

    lines = _build._target(name)[2].read_text().splitlines()
    regs = spill = None
    for i, line in enumerate(lines):
        if "Compiling entry" in line and entry in line:
            for nxt in lines[i + 1:i + 5]:
                m = re.search(r"Used (\d+) registers", nxt)
                regs = int(m.group(1)) if m and regs is None else regs
                m = re.search(r"(\d+) bytes spill stores", nxt)
                spill = int(m.group(1)) if m and spill is None else spill
    return regs, spill


def _redesigned_timing(torch, label, kern, p0, persistent, staged, tag, entries, reps=5):
    """The persistent entry (one launch a solve) and its staged sequence on
    one prepared problem, each call from p0: ms a solve by CUDA events in
    turns (staged, persistent, persistent, staged), host launch calls a
    solve (profiler over 2 calls) and the ptxas registers and spills of the
    persistent kernels (entries: (source, kernel name), ...)."""
    def from_p0(fn):
        def call():
            kern.poses.copy_(p0)
            fn()
        return call

    new, old = from_p0(persistent), from_p0(staged)
    t_oa = _event_us(torch, old, reps, warmup=1) / 1e3
    t_na = _event_us(torch, new, reps, warmup=1) / 1e3
    t_nb = _event_us(torch, new, reps, warmup=1) / 1e3
    t_ob = _event_us(torch, old, reps, warmup=1) / 1e3
    host, _ = _launches_per_call(torch, new, tag, calls=2)
    host_s, _ = _launches_per_call(torch, old, tag, calls=2)
    out = dict(ms=min(t_na, t_nb), ms_staged=min(t_oa, t_ob), launches=host,
               staged_launches=host_s, ptxas={})
    for src, entry in entries:
        out["ptxas"][entry] = _ptxas(src, entry)
    log(f"  {label}, C entries in turns (CUDA events): one launch {t_na:.3f} and {t_nb:.3f} ms "
        f"a solve, staged {t_oa:.3f} and {t_ob:.3f} ms ({out['ms_staged'] / out['ms']:.2f}x); "
        f"host launch calls a solve (profiler, 2 calls): {host:g}, staged {host_s:g}; ptxas "
        + ", ".join(f"{e} {r} registers, {sp} bytes spill stores"
                    for e, (r, sp) in out["ptxas"].items()))
    if host != 1:
        fail(f"{label}: the persistent entry made {host} launch calls a solve, not 1")
    return out


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
    for name, p, gg, kw in variants[2:4]:
        _persistent_bitwise(torch, gk.GnKernel, p, gg, f"K1 {name}, 5 iterations")
    _persistent_bitwise(torch, gk.GnKernel, p0, g, "K1 warm + ramp", phases=((3, 25), (2, 12)),
                        warm=True)


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
    _persistent_bitwise(torch, gk.GnKernel, p0, g, f"K1 m3500, {iters} iterations",
                        levels=cfg.pcr_levels, phases=((iters, cfg.cg_max_iterations),))
    city = datasets.city10000()
    gc, pc = from_dataset(city, device=dev), torch.from_numpy(city["poses"]).to(dev)
    _persistent_bitwise(torch, gk.GnKernel, pc, gc, "K1 city10000 (16 CTAs walking 40 row "
                        "blocks), 5 iterations", levels=cfg.pcr_levels)
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
    kern = gk.GnKernel(p0, g, -1.0, cfg.pcr_levels, cg_max=cfg.cg_max_iterations)
    phases = ((iters, cfg.cg_max_iterations),)
    red = _redesigned_timing(torch, f"K1 m3500 GN ({iters} iterations)", kern, p0,
                             lambda: kern.solve(phases, False),
                             lambda: kern.solve_staged(phases, False), "GnProblem",
                             (("gn_kernel", "k_gn_persistent"),))
    groups, span = _profile_launches(torch, lambda: kernel(p0))
    red["idle_share"] = _log_profile(f"m3500 K1 GN solve through fused_gn_solve ({iters} "
                                     f"iterations)", groups, span, iters)
    return ms_k, ms_p, red


def _event_us(torch, fn, reps: int, warmup: int = 3) -> float:
    """Microseconds per call of fn, by CUDA events around `reps` calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / reps


def _graph_us(torch, launch, launches: int = 50, replays: int = 20) -> float:
    """Microseconds a launch, by CUDA events around `replays` replays of a
    CUDA graph of `launches` calls of launch(stream): the device's time,
    without the host's work between launches. launch(stream) enqueues on
    the stream it is given."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            launch(side.cuda_stream)
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        stream = torch.cuda.current_stream().cuda_stream
        for _ in range(launches):
            launch(stream)
    graph.replay()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(replays):
        graph.replay()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / (replays * launches)


def _bound(nbytes: float, flops: float):
    """(least ms, what bounds it): bytes read and written once over the
    card's memory rate, or float32 operations over its peak rate."""
    tb, tf = nbytes / HBM_BYTES_PER_S, flops / F32_FLOPS_PER_S
    return 1e3 * max(tb, tf), ("bytes" if tb >= tf else "operations")


def gn_cost(N: int, c: int, El: int, K: int, iters: int, cg: int):
    """Bytes (inputs read once, poses written once) and float32 operations
    of one fused GN solve, counted from the kernel's stages."""
    nbytes = 12 * N + 48 * c + 48 + 56 * El + 12 * N
    per_cg = N * (54 + 36 * K + 18 + 10) + 72 * El  # H@p, K-level PCR apply, Dinv, dots
    per_gn = (250 * (c + El) + 60 * N      # linearize + assemble
              + 400 * K * N                # PCR factor
              + (cg + 1) * per_cg          # CG, with its initial residual
              + 40 * N)                    # retract
    return nbytes, iters * per_gn


def gn_cg_stream_bytes(N: int, El: int, K: int) -> int:
    """Bytes one CG iteration touches if its working set came from device
    memory: D, U, the K PCR levels and Dinv, five vectors read and written,
    the loop blocks with their indices and the CSR."""
    return 72 * N + 72 * N + 72 * K * N + 36 * N + 5 * 24 * N + 44 * El + 8 * El + 4 * N


def icp_iteration_cost(P: int, Q: int):
    """One K2 iteration: moved, jtheta, mask, rotated covs in; targets,
    validity, covs in; 13 sums out. Five operations per distance, ~60 per
    matched point."""
    return P * (8 + 8 + 1 + 12) + Q * (8 + 1 + 12) + 13 * 4, 5 * P * Q + 60 * P


def nn_cost(P: int, Q: int):
    return P * 8 + Q * 9 + P * 8, 5 * P * Q


def _random_k2_inputs(torch, dev, P: int, Q: int, seed: int):
    """tests/test_icp_kernel.py::make_inputs, drawn with numpy."""
    import numpy as np

    rng = np.random.default_rng(seed)
    f = np.float32
    A = (rng.normal(size=(Q, 2, 2)) * 0.3).astype(f)
    arrs = (
        rng.normal(size=(P, 2)).astype(f), rng.normal(size=(P, 2)).astype(f),
        rng.random(P) < 0.9, rng.normal(size=(Q, 2)).astype(f), rng.random(Q) < 0.85,
        (np.einsum("qij,qkj->qik", A, A) + 0.1 * np.eye(2)).astype(f),
        (np.abs(rng.normal(size=(P, 3))) * np.array([1.0, 0.1, 1.0])).astype(f),
    )
    return [torch.from_numpy(a).to(dev) for a in arrs]


def _k2_full_width(torch, icp, ik, tour, t: int):
    """K2's inputs at the main path's shapes: scan t+1 against scan t at the
    odometry guess."""
    src, sm, tgt, tm = tour["pts"][t + 1], tour["masks"][t + 1], tour["pts"][t], tour["masks"][t]
    init = tour["odom"][t + 1]
    moved, jtheta = ik._round_inputs(src, init)
    Cs, Ct = icp.surfel_covs(src, sm, 4, 1e-3), icp.surfel_covs(tgt, tm, 4, 1e-3)
    return [moved, jtheta, sm, tgt, tm, Ct, ik.rotated_covs(ik._packed(Cs), init[2])]


def phase_frontend_kernels(torch, tour):
    log("== phase 6: frontend kernels against their plain twins")
    from graphslam_tpu_torch.frontend import icp
    from graphslam_tpu_torch.ops import correspondence as cc
    from graphslam_tpu_torch.ops import icp_kernel as ik

    dev = torch.device("cuda")
    k2_cases = [(f"full width, scan {t + 1} on scan {t}", _k2_full_width(torch, icp, ik, tour, t), 1.0)
                for t in (0, 100, 200)]
    k2_cases.append(("unaligned P=200 Q=256", _random_k2_inputs(torch, dev, 200, 256, 1), 1.0))
    no_valid = _random_k2_inputs(torch, dev, 256, 384, 2)
    no_valid[4] = torch.zeros_like(no_valid[4])
    k2_cases.append(("no valid target", no_valid, 1.0))
    k2_ratio = 0.0
    for name, args, mc2 in k2_cases:
        ours = ik.fused_icp_iteration(*args, max_corr2=mc2, eps=1e-6)
        ref = ik.fused_icp_iteration_reference(*args, max_corr2=mc2, eps=1e-6)
        torch.cuda.synchronize()
        worst = []
        for label, a, b, (rtol, atol) in zip(("H", "g", "stats"), ours, ref, TOL_K2):
            # |a - b| over its limit atol + rtol |b|: at most 1 passes
            ratio = float(((a - b).abs() / (atol + rtol * b.abs())).max())
            err = float((a - b).abs().max())
            worst.append(f"{label} {err:.3e} ({ratio:.3f} of the limit)")
            if not ratio <= 1.0:
                fail(f"K2 {name}: {label} differs from the twin by {err} (rtol {rtol}, atol {atol})")
            k2_ratio = max(k2_ratio, ratio)
        log(f"  K2 {name}: max abs err {', '.join(worst)}; (rtol, atol) {TOL_K2}")

    import numpy as np

    rng = np.random.default_rng(7)
    full = k2_cases[0][1]
    k8_cases = [("full width", full[0], full[3], full[4])]
    for name, P, Q in (("unaligned P=200 Q=300", 200, 300), ("ties", 200, 300),
                       ("no valid target", 200, 300)):
        s_, t_ = rng.normal(size=(P, 2)).astype(np.float32), rng.normal(size=(Q, 2)).astype(np.float32)
        v_ = rng.random(Q) < 0.8
        if name == "ties":
            s_, t_ = np.round(s_ * 2) / 2, np.round(t_ * 2) / 2
        if name == "no valid target":
            v_[:] = False
        k8_cases.append((name, *(torch.from_numpy(a).to(dev) for a in (s_, t_, v_))))
    k8_err = 0.0
    for name, src, tgt, valid in k8_cases:
        idx, d2 = cc.nearest_neighbors(src, tgt, valid)
        ridx, rd2 = cc.nearest_neighbors_reference(src, tgt, valid)
        sidx, sd2 = cc.nearest_neighbors_serial(src, tgt, valid)
        torch.cuda.synchronize()
        if not (torch.equal(idx, sidx) and torch.equal(d2.view(torch.int32), sd2.view(torch.int32))):
            fail(f"K8 {name}: nn_search (a group of threads a point) differs from "
                 f"nn_search_serial")
        same = torch.isinf(rd2) & torch.isinf(d2)
        rel = float(torch.where(same, 0.0, (d2 - rd2).abs() / rd2.abs().clamp_min(1e-30)).max())
        if not torch.equal(idx, ridx) or not rel <= TOL_K8_D2_REL:
            fail(f"K8 {name}: indices equal {torch.equal(idx, ridx)}, distance rel err {rel}")
        if name == "full width":
            k8_err = float((d2 - rd2).abs().max())
        log(f"  K8 {name}: indices equal, distance rel err {rel:.3e} (tol {TOL_K8_D2_REL}); "
            f"nn_search (one launch) vs nn_search_serial: bitwise equal")

    match_err, pairs = 0.0, range(0, tour["n"] - 1, 50)
    for t in pairs:
        args = (tour["pts"][t + 1], tour["masks"][t + 1], tour["pts"][t], tour["masks"][t])
        kw = dict(init_delta=tour["odom"][t + 1], iterations=32)
        kern = icp.gicp_match(*args, **kw)
        plain = icp.gicp_match(*args, use_kernel=False, **kw)
        err = float((kern.delta - plain.delta).abs().max())
        match_err = max(match_err, err)
        if not err <= TOL_MATCH_DELTA:
            fail(f"gicp_match kernel vs plain, scan {t + 1} on {t}: delta differs by {err}")
    log(f"  gicp_match kernel vs plain on {len(pairs)} scan pairs: delta max err {match_err:.3e} "
        f"(tol {TOL_MATCH_DELTA})")
    return dict(k2_ratio=k2_ratio, k8_err=k8_err, match_err=match_err), full


def _dead_reckoned(torch, se2, gt0, odom):
    poses = [torch.as_tensor(gt0)]
    for d in odom:
        poses.append(se2.compose(poses[-1], torch.as_tensor(d)))
    return torch.stack(poses)


def _zero_counts(gk, ik, cc):
    gk.fused_gn_solve.launches = 0
    ik.fused_icp_loop.launches = 0
    ik.fused_icp_iteration.launches = 0
    cc.nearest_neighbors.launches = 0


def _lockstep(torch, tour, n_cmp: int):
    """The replay's first n_cmp scans through the kernels, and each step
    again through the plain twins on the card from a copy of the same state:
    the same keyframe and loop decisions and factor counts, and keyframe
    poses within wrapped TOL_POSES_WRAPPED. Returns (worst pose difference
    at steps without a loop commit, at loop commits, loops)."""
    from graphslam_tpu_torch.slam.pipeline import make_slam_step
    from graphslam_tpu_torch.slam.state import init_state

    cfg = tour["cfg"]
    step_k, step_p = make_slam_step(cfg), make_slam_step(cfg, use_kernels=False)
    sk = init_state(cfg)
    worst = [0.0, 0.0]
    for t in range(n_cmp):
        sp = dataclasses.replace(sk, **{f.name: getattr(sk, f.name).clone()
                                        for f in dataclasses.fields(sk)})
        sk, ik_ = step_k(sk, tour["scans"][t], tour["odom"][t])
        sp, ip = step_p(sp, tour["scans"][t], tour["odom"][t])
        for f in ("is_keyframe", "added_loop", "num_factors"):
            if not torch.equal(getattr(ik_, f), getattr(ip, f)):
                fail(f"scan {t}: {f} through the kernels {getattr(ik_, f).tolist()}, "
                     f"through the plain twins {getattr(ip, f).tolist()}")
        nk, loop = int(sp.num_kf), bool(ip.added_loop)
        err = wrapped_max(sk.kf_poses[:nk], sp.kf_poses[:nk])
        worst[loop] = max(worst[loop], err)
        if not err <= TOL_POSES_WRAPPED:
            fail(f"scan {t}: keyframe poses through the kernels and the plain twins differ by "
                 f"{err} (tol {TOL_POSES_WRAPPED})")
    return worst[0], worst[1], int(sk.num_loops)


def _bucket_solve_pair(torch, gk, tour, state):
    """K1 against its twin at the replay's own solve: the occupancy bucket of
    the replay's final map (a prior on every pose, every loop slot, most of
    them masked), warm-started CG at the config's depth and PCR levels, from
    the keyframe poses with seeded noise."""
    from graphslam_tpu_torch.slam.pipeline import _solve_buckets, graph_view

    cfg = tour["cfg"]
    nkf = int(state.num_kf)
    B = next(b for b in _solve_buckets(cfg.max_keyframes, cfg.solve_bucket_min) if b >= nkf)
    g = graph_view(state, cfg, B)
    gen = torch.Generator(device="cpu").manual_seed(3)
    noise = torch.randn((B, 3), generator=gen) * torch.tensor([0.02, 0.02, 0.01])
    noise[nkf:] = 0.0
    p0 = state.kf_poses[:B] + noise.to(state.kf_poses.device)
    err = _solve_pair(torch, gk, p0, g, iterations=cfg.solve_iterations,
                      cg_iters=cfg.solver.cg_max_iterations, pcr_levels=cfg.solver.pcr_levels,
                      warm_start=True)
    live = int(g.edge_mask[g.chain_prefix:].sum())
    log(f"  K1 at the replay's solve (bucket {B}, {nkf} keyframes, {live} of "
        f"{g.num_edges - g.chain_prefix} loop slots live, pcr_levels {cfg.solver.pcr_levels}, "
        f"warm, {cfg.solve_iterations} x cg {cfg.solver.cg_max_iterations}): wrapped max err "
        f"{err:.3e} (tol {TOL_POSES_WRAPPED})")
    if not err <= TOL_POSES_WRAPPED:
        fail(f"K1 at the replay's solve differs from the plain twin: {err}")
    _persistent_bitwise(torch, gk.GnKernel, p0, g, f"K1 at the replay's solve (bucket {B}, one "
                        "CTA)", levels=cfg.solver.pcr_levels, warm=True,
                        phases=((cfg.solve_iterations, cfg.solver.cg_max_iterations),))
    return err


def phase_replay(torch, metrics, tour):
    log("== phase 7: online pipeline main path on cuda "
        f"({tour['n']}-scan replay, bench_all.py's frontend config)")
    from graphslam_tpu_torch.geometry import se2
    from graphslam_tpu_torch.ops import correspondence as cc
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.ops import icp_kernel as ik
    from graphslam_tpu_torch.slam.pipeline import make_slam_replay
    from graphslam_tpu_torch.slam.state import init_state

    cfg, n = tour["cfg"], tour["n"]
    replay = make_slam_replay(cfg, n)
    _zero_counts(gk, ik, cc)
    state, infos = replay(init_state(cfg), tour["scans"], tour["odom"])
    torch.cuda.synchronize()
    launches = {"gn_kernel": gk.fused_gn_solve.launches, "icp_kernel": ik.fused_icp_loop.launches,
                "icp_iteration": ik.fused_icp_iteration.launches,
                "nn_kernel": cc.nearest_neighbors.launches}
    log(f"  launches in the replay: fused_gn_solve {launches['gn_kernel']}, fused_icp_loop "
        f"{launches['icp_kernel']} (fused_icp_iteration {launches['icp_iteration']}, "
        f"nearest_neighbors {launches['nn_kernel']}: not on this path)")
    if launches["gn_kernel"] <= 0 or launches["icp_kernel"] <= 0:
        fail("the replay did not launch both of its kernels")

    nkf, nloops = int(state.num_kf), int(state.num_loops)
    steps = torch.nonzero(infos.is_keyframe).flatten().cpu()
    if steps.numel() != nkf:
        fail(f"{steps.numel()} keyframe steps but num_kf {nkf}")
    if not torch.isfinite(state.kf_poses[:nkf]).all() or not torch.isfinite(state.kf_covs[:nkf]).all():
        fail("replay poses or covariances are not finite")
    gt = torch.from_numpy(tour["gt"])
    ate = float(metrics.ate(state.kf_poses[:nkf].cpu(), gt[steps]))
    dead = _dead_reckoned(torch, se2, tour["gt"][0], tour["odom_np"][1:])
    ate_dead = float(metrics.ate(dead[steps], gt[steps]))
    log(f"  {nkf} keyframes, {nloops} loop closures, {int(infos.num_factors[-1])} factors; "
        f"replay ATE {ate:.4f} m, dead-reckoned ATE {ate_dead:.4f} m")
    ref = JAX_REPLAY
    log(f"  JAX package on the CPU: {ref['keyframes']} keyframes, {ref['loops']} loops, "
        f"ATE {ref['ate']:.4f} m, dead-reckoned {ref['ate_dead_reckoned']:.4f} m")
    if not (abs(nkf - ref["keyframes"]) <= 3 and nloops >= ref["loops"] - 2
            and ate <= ref["ate"] + 0.02 and ate < 0.5 * ate_dead):
        fail(f"replay gate failed: {nkf} keyframes, {nloops} loops, ATE {ate}, dead {ate_dead}")

    state2, infos2 = replay(init_state(cfg), tour["scans"], tour["odom"])
    torch.cuda.synchronize()
    for f in dataclasses.fields(state):
        if not torch.equal(getattr(state, f.name), getattr(state2, f.name)):
            fail(f"two replays differ in {f.name}")
    for a, b in zip(infos, infos2):
        if not torch.equal(a, b):
            fail("two replays differ in their step infos")
    log("  two replays bitwise equal (every state field and step info)")

    gn_err = _bucket_solve_pair(torch, gk, tour, state)
    loop_steps = torch.nonzero(infos.added_loop).flatten().tolist()
    n_cmp = min(n, max(60, loop_steps[0] + 20 if loop_steps else 0))
    plain_err, loop_err, lk = _lockstep(torch, tour, n_cmp)
    log(f"  kernels vs plain twins, each of the first {n_cmp} steps from the same state ({lk} "
        f"loop commits from scan {loop_steps[0] if loop_steps else '-'}): decisions and factor "
        f"counts equal, keyframe poses wrapped max err {plain_err:.3e} (steps without a loop "
        f"commit), {loop_err:.3e} (loop commits), tol {TOL_POSES_WRAPPED}")
    return launches, gn_err, state


def phase_timing_frontend(torch, tour, k2_full):
    log("== phase 8: online pipeline timing")
    import ctypes
    import warnings

    from graphslam_tpu_torch.frontend import icp
    from graphslam_tpu_torch.ops import correspondence as cc
    from graphslam_tpu_torch.ops import icp_kernel as ik
    from graphslam_tpu_torch.slam.pipeline import make_slam_replay
    from graphslam_tpu_torch.slam.state import init_state

    cfg, n = tour["cfg"], tour["n"]
    out = {}

    def fps(replay, scans, odom, steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        replay(init_state(cfg), scans, odom)
        torch.cuda.synchronize()
        return steps / (time.perf_counter() - t0)

    n60 = 60
    kern_full = make_slam_replay(cfg, n)
    kern_60 = make_slam_replay(cfg, n60)
    plain_60 = make_slam_replay(cfg, n60, use_kernels=False)
    s60, o60 = tour["scans"][:n60], tour["odom"][:n60]
    loop_k2 = ik.fused_icp_loop

    def staged_k2(fn):
        """fn() with gicp_match's loop through the staged K2 entry."""
        ik.fused_icp_loop = ik.fused_icp_loop_staged
        try:
            return fn()
        finally:
            ik.fused_icp_loop = loop_k2

    def replay_full():
        return fps(kern_full, tour["scans"], tour["odom"], n)

    # in turns: staged K2, K2, K2, K2, staged K2
    runs_staged = [staged_k2(replay_full)]
    runs_full = [replay_full() for _ in range(3)]
    runs_staged.append(staged_k2(replay_full))
    runs_60 = [fps(kern_60, s60, o60, n60) for _ in range(3)]
    plain = fps(plain_60, s60, o60, n60)
    out["fps"] = statistics.median(runs_full)
    out["fps_k2_staged"] = max(runs_staged)
    out["fps_60"] = statistics.median(runs_60)
    out["plain_fps_60"] = plain
    log(f"  card: {tour['card']}")
    log(f"  replay through the kernels: {out['fps']:.2f} frames/s over {n} scans (median of 3: "
        f"{', '.join(f'{x:.2f}' for x in runs_full)}); with K2 through icp_match_staged "
        f"{runs_staged[0]:.2f} before and {runs_staged[1]:.2f} after")
    log(f"  first {n60} scans: kernels {out['fps_60']:.2f} frames/s (median of 3), plain twins "
        f"on the card {plain:.2f} frames/s (one run)")

    # The replay through K2's one launch a match against the replay through
    # its staged launches: every state field and step info bit for bit.
    state_a, infos_a = kern_full(init_state(cfg), tour["scans"], tour["odom"])
    state_b, infos_b = staged_k2(lambda: kern_full(init_state(cfg), tour["scans"], tour["odom"]))
    torch.cuda.synchronize()
    for f in dataclasses.fields(state_a):
        if not torch.equal(getattr(state_a, f.name), getattr(state_b, f.name)):
            fail(f"the replay through icp_match and through icp_match_staged differ in {f.name}")
    for a, b in zip(infos_a, infos_b):
        if not torch.equal(a, b):
            fail("the replay through icp_match and through icp_match_staged differ in their "
                 "step infos")
    log(f"  replay through icp_match (one launch a match) vs icp_match_staged: bitwise equal "
        f"(every state field and step info; {int(state_a.num_kf)} keyframes, "
        f"{int(state_a.num_loops)} loops)")

    # K2's IRLS rounds that ran over one replay (the sum of each match's
    # ctrl[1]) beside the rounds the staged entry enqueues (icp_iterations a
    # match): the one-launch loop runs no round after convergence.
    ctrls, loop = [], ik._loop

    def counting(*a, **kw):
        res, ctrl = loop(*a, **kw)
        ctrls.append(ctrl)
        return res, ctrl

    ik._loop = counting
    try:
        kern_full(init_state(cfg), tour["scans"], tour["odom"])
    finally:
        ik._loop = loop
    rounds = cfg.frontend.icp_iterations
    out["k2_matches"] = len(ctrls)
    out["k2_rounds_enqueued"] = rounds * len(ctrls)
    out["k2_rounds_run"] = int(torch.stack(ctrls)[:, 1].sum()) if ctrls else 0
    log(f"  K2 IRLS rounds over the replay: {out['k2_rounds_run']} run in {out['k2_matches']} "
        f"matches ({out['k2_rounds_enqueued']} enqueued by icp_match_staged: {rounds} rounds "
        f"a match)")

    # K2: one IRLS iteration at full width, the C entries on a prepared
    # problem in turns (staged, one launch, one launch, staged), against the
    # twin; the C entries of a whole match likewise, and their launches.
    args = k2_full
    prob, keep = ik._problem(args[0], args[1], args[6], args[2], args[3], args[4],
                             ik._packed(args[5]), 1.0, 1e-6)
    lib = ik._lib()

    def round_(fn):
        return lambda: getattr(lib, fn)(ctypes.byref(prob))
    t_sa = _event_us(torch, round_("icp_iteration_staged"), 500)
    t_na = _event_us(torch, round_("icp_iteration"), 500)
    t_nb = _event_us(torch, round_("icp_iteration"), 500)
    t_sb = _event_us(torch, round_("icp_iteration_staged"), 500)
    out["k2_us"], out["k2_staged_us"] = min(t_na, t_nb), min(t_sa, t_sb)
    out["k2_plain_us"] = _event_us(torch, lambda: ik.fused_icp_iteration_reference(
        *args, max_corr2=1.0, eps=1e-6), 50)
    log(f"  K2, one IRLS iteration at P = Q = {args[0].shape[0]} on {lib.icp_ctas(args[0].shape[0])} "
        f"CTAs (C entries in turns, CUDA events): one launch {t_na:.2f} and {t_nb:.2f} us, "
        f"staged (2 launches) {t_sa:.2f} and {t_sb:.2f} us ({out['k2_staged_us'] / out['k2_us']:.2f}x); "
        f"plain twin {out['k2_plain_us']:.2f} us")

    pair = (tour["pts"][1], tour["masks"][1], tour["pts"][0], tour["masks"][0])
    Cs = icp.surfel_covs(pair[0], pair[1], 4, 1e-3)
    Ct = icp.surfel_covs(pair[2], pair[3], 4, 1e-3)
    mprob, mkeep = ik._problem(pair[0], None, ik._packed(Cs), pair[1], pair[2], pair[3],
                               ik._packed(Ct), 1.0, 1e-6, 1e-5)
    delta = tour["odom"][1].clone()
    mprob.delta = delta.data_ptr()

    def match_entry(fn):
        def call():
            delta.copy_(tour["odom"][1])
            getattr(lib, fn)(ctypes.byref(mprob), 32, 1)
        return call
    t_sa = _event_us(torch, match_entry("icp_match_staged"), 200)
    t_na = _event_us(torch, match_entry("icp_match"), 200)
    t_nb = _event_us(torch, match_entry("icp_match"), 200)
    t_sb = _event_us(torch, match_entry("icp_match_staged"), 200)
    out["k2_match_entry_us"], out["k2_match_entry_staged_us"] = min(t_na, t_nb), min(t_sa, t_sb)
    host, _ = _launches_per_call(torch, lambda: lib.icp_match(ctypes.byref(mprob), 32, 1),
                                 "IcpProblem")
    host_s, _ = _launches_per_call(torch, lambda: lib.icp_match_staged(ctypes.byref(mprob), 32, 1),
                                   "IcpProblem")
    out["k2_launches_per_match"], out["k2_staged_launches_per_match"] = host, host_s
    match_entry("icp_match")()
    torch.cuda.synchronize()
    out["k2_rounds_pair"] = int(mkeep[10][1])
    out["k2_ptxas"] = {e: _ptxas("icp_kernel", e) for e in ("k_icp_roundsILb1E",
                                                           "k_icp_roundsILb0E")}
    log(f"  K2, one match at full width (scan 1 on scan 0, 32 rounds, early exit: "
        f"{out['k2_rounds_pair']} run; C entries in turns, CUDA events): icp_match {t_na:.2f} "
        f"and {t_nb:.2f} us, icp_match_staged {t_sa:.2f} and {t_sb:.2f} us; host launch calls a "
        f"match (profiler, 10 calls): {host:g}, staged {host_s:g}; ptxas "
        + ", ".join(f"k_icp_rounds<{'true' if '1E' in e else 'false'}> {r} registers, {sp} bytes "
                    f"spill stores" for e, (r, sp) in out["k2_ptxas"].items()))
    if host != 1:
        fail(f"icp_match made {host} launch calls a match, not 1")

    def match():
        return icp.gicp_match(*pair, init_delta=tour["odom"][1], iterations=32)
    t_sa = _event_us(torch, lambda: staged_k2(match), 50)
    t_na = _event_us(torch, match, 50)
    t_nb = _event_us(torch, match, 50)
    t_sb = _event_us(torch, lambda: staged_k2(match), 50)
    out["match_us"], out["match_staged_us"] = min(t_na, t_nb), min(t_sa, t_sb)
    out["match_plain_us"] = _event_us(torch, lambda: icp.gicp_match(
        *pair, init_delta=tour["odom"][1], iterations=32, use_kernel=False), 10)
    log(f"  gicp_match, scan 1 on scan 0 (32 iterations, early exit; in turns): {t_na:.2f} and "
        f"{t_nb:.2f} us through icp_match, {t_sa:.2f} and {t_sb:.2f} us through "
        f"icp_match_staged, {out['match_plain_us']:.2f} us plain")

    # K8 at full width, the C entries in turns with the serial shape it
    # replaced (serial, one launch, one launch, serial): per launch from
    # replays of a CUDA graph of launches (the device's time), and per call
    # by CUDA events around back-to-back calls (the host's ctypes work
    # included); against the twin and torch.cdist over the valid targets.
    src, tgt, valid = args[0], args[3], args[4]
    P, Q = src.shape[0], tgt.shape[0]
    idx = torch.empty(P, dtype=torch.int32, device=src.device)
    d2 = torch.empty(P, dtype=torch.float32, device=src.device)
    ptrs = (src.data_ptr(), tgt.data_ptr(), valid.data_ptr(), idx.data_ptr(), d2.data_ptr(), P, Q)

    def nn(fn):
        return lambda stream: getattr(lib, fn)(*ptrs, ctypes.c_void_p(stream))

    def on_current(launch):
        return lambda: launch(torch.cuda.current_stream().cuda_stream)
    for fn in ("nn_search", "nn_search_serial"):
        rc = on_current(nn(fn))()
        if rc:
            fail(f"K8: {fn} returned CUDA error {rc}")
    t_sa = _graph_us(torch, nn("nn_search_serial"))
    t_na = _graph_us(torch, nn("nn_search"))
    t_nb = _graph_us(torch, nn("nn_search"))
    t_sb = _graph_us(torch, nn("nn_search_serial"))
    c_sa = _event_us(torch, on_current(nn("nn_search_serial")), 500)
    c_na = _event_us(torch, on_current(nn("nn_search")), 500)
    c_nb = _event_us(torch, on_current(nn("nn_search")), 500)
    c_sb = _event_us(torch, on_current(nn("nn_search_serial")), 500)
    out["k8_launch_us"], out["k8_serial_launch_us"] = min(t_na, t_nb), min(t_sa, t_sb)
    out["k8_us"], out["k8_serial_us"] = min(c_na, c_nb), min(c_sa, c_sb)
    host, dev_n = _launches_per_call(torch, on_current(nn("nn_search")), "k_nn")
    host_s, _ = _launches_per_call(torch, on_current(nn("nn_search_serial")), "k_nn_serial")
    out["k8_launches_per_call"], out["k8_serial_launches_per_call"] = host, host_s
    src_text = (ROOT / "graphslam_tpu_torch" / "csrc" / "icp_kernel.cu").read_text()
    group, threads = (int(re.search(rf"constexpr int {c} = (\d+);", src_text).group(1))
                      for c in ("kNnGroup", "kNnThreads"))
    out["k8_shape"] = (group, threads)
    out["k8_ptxas"] = {f"k_nn<{group}>": _ptxas("icp_kernel", f"k_nnILi{group}E")}
    out["k8_plain_us"] = _event_us(torch, lambda: cc.nearest_neighbors_reference(src, tgt, valid),
                                   100)
    tv = tgt[valid].contiguous()
    out["k8_cdist_us"] = _event_us(torch, lambda: torch.cdist(
        src, tv, compute_mode="donot_use_mm_for_euclid_dist").min(1), 200)
    regs, spill = out["k8_ptxas"][f"k_nn<{group}>"]
    log(f"  K8 at P = Q = {P} ({tv.shape[0]} valid targets), C entries in turns: nn_search (a "
        f"group of {group} threads a point, {threads}-thread CTAs) {t_na:.2f} and {t_nb:.2f} us "
        f"a launch (CUDA graph replays), nn_search_serial {t_sa:.2f} and {t_sb:.2f} us "
        f"({out['k8_serial_launch_us'] / out['k8_launch_us']:.2f}x); a call by CUDA events "
        f"(host work included) {c_na:.2f} and {c_nb:.2f} us, serial {c_sa:.2f} and {c_sb:.2f} "
        f"us ({out['k8_serial_us'] / out['k8_us']:.2f}x); plain "
        f"twin {out['k8_plain_us']:.2f} us, torch.cdist(...).min(1) {out['k8_cdist_us']:.2f} us; "
        f"launches a call (profiler, 10 calls; host launch calls / device kernels): {host:g} / "
        f"{dev_n:g}, serial {host_s:g}; ptxas k_nn<{group}> {regs} registers, {spill} bytes "
        f"spill stores")
    if host != 1:
        fail(f"K8 made {host} launch calls a call, not 1")

    # Host synchronizations per scan (CUDA sync debug mode) over the first scans.
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            _, inf60 = kern_60(init_state(cfg), s60, o60)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    syncs = sum("synchroniz" in str(w.message) for w in caught)
    out["syncs_per_scan"] = syncs / n60
    out["keyframes_60"] = int(inf60.is_keyframe.sum())
    log(f"  host synchronizations over the first {n60} scans ({out['keyframes_60']} keyframes): "
        f"{syncs}, {out['syncs_per_scan']:.2f} per scan")

    # One profiled replay: device busy share and launches per scan.
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        kern_full(init_state(cfg), tour["scans"], tour["odom"])
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    by_name, busy_us, kernels = {}, 0.0, 0
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0) or 0.0
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            by_name[e.key] = (e.count, dev_us)
    for name, (count, dev_us) in by_name.items():
        busy_us += dev_us
        if not name.startswith("Memcpy") and not name.startswith("Memset"):
            kernels += count
    out["profile_span_s"] = span
    if busy_us > 0:
        out["busy_ms"] = busy_us / 1e3
        out["idle_share"] = 1.0 - busy_us / 1e6 / span
        out["kernels_per_scan"] = kernels / n
        top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
        log(f"  profiled replay: {span * 1e3:.1f} ms span, device busy {busy_us / 1e3:.1f} ms, "
            f"idle share {out['idle_share']:.3f}, {kernels} kernel launches "
            f"({out['kernels_per_scan']:.1f} per scan)")
        for name, (count, dev_us) in top:
            log(f"    {dev_us / 1e3:9.3f} ms  {count:7d}x  {name[:90]}")
        groups = {}
        for name, (count, dev_us) in by_name.items():
            g = ("gn_kernel.cu" if "GnProblem" in name else "icp_kernel.cu"
                 if "IcpProblem" in name else "memcpy/memset"
                 if name.startswith(("Memcpy", "Memset")) else "torch ops")
            c0, d0 = groups.get(g, (0, 0.0))
            groups[g] = (c0 + count, d0 + dev_us)
        for g, (count, dev_us) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
            log(f"    by source: {g:14s} {count / n:7.1f} launches a scan, "
                f"{dev_us / 1e3:9.3f} device ms")
    else:
        log("  profiled replay: the profiler saw no device time; busy share not measured")
    return out



# ---------------------------------------------------------------------------
# Levenberg-Marquardt: K1's LM mode and K3
# ---------------------------------------------------------------------------


def _lm_pair(torch, gk, p0, g, iterations=5, cg_iters=25, **kw):
    """fused_lm_solve through the kernel and through its twin on the card:
    (wrapped pose error, chi2 relative error, kernel stats, twin stats)."""
    out = gk.fused_lm_solve(p0, g, iterations=iterations, cg_iters=cg_iters, **kw)
    ref = gk.fused_lm_solve_reference(p0, g, iterations=iterations, cg_iters=cg_iters, **kw)
    torch.cuda.synchronize()
    if not torch.isfinite(out[0]).all():
        fail(f"the LM kernel produced non-finite poses ({kw})")
    ks, rs = [float(t) for t in out[1:]], [float(t) for t in ref[1:]]
    return wrapped_max(out[0], ref[0]), abs(ks[0] - rs[0]) / abs(rs[0]), ks, rs


def _check_lm_pair(name, e, ce, ks, rs):
    log(f"  K1-LM {name}: wrapped max err {e:.3e} (tol {TOL_LM_POSES}), chi2 {ks[0]:.4f} vs "
        f"{rs[0]:.4f} (rel {ce:.2e}, tol {TOL_CHI2_REL}), lam {ks[1]:.3g} vs {rs[1]:.3g}, "
        f"accepted {ks[2]:.0f} vs {rs[2]:.0f}, converged {ks[3]:.0f} vs {rs[3]:.0f}")
    if not (e <= TOL_LM_POSES and ce <= TOL_CHI2_REL and ks[2:] == rs[2:]):
        fail(f"K1-LM {name} differs from its plain twin")


def _k3_pair(torch, pk, sysm, lam, chain_prefix):
    """K3 and its twin on one system: (relative error, absolute error)."""
    x = pk.fused_pcg_solve(sysm, lam, max_iters=25, chain_prefix=chain_prefix)
    xr = pk.fused_pcg_solve_reference(sysm, lam, max_iters=25, chain_prefix=chain_prefix)
    torch.cuda.synchronize()
    if not torch.isfinite(x).all():
        fail("K3 produced a non-finite solution")
    return rel_err(x, xr), float((x - xr).abs().max())


def _k3_bitwise(torch, pk, sysm, lam, chain_prefix, label):
    """K3 (one persistent launch) against the staged gn_factor + gn_cg it
    replaced, on the same prepared problem, and two K3 calls: bitwise."""
    kern = pk.PcgKernel(*pk._chain_and_loops(sysm, lam, True, chain_prefix), 25)
    a = kern.solve().clone()
    b = kern.staged().clone()
    again = kern.solve().clone()
    torch.cuda.synchronize()
    same = torch.equal(a, b) and torch.equal(a, again)
    log(f"  K3 {label}: persistent vs staged gn_factor + gn_cg, and two calls: "
        f"{'bitwise equal' if same else 'DIFFERENT'} (max |x| {float(a.abs().max()):.4g})")
    if not same:
        fail(f"K3 {label}: the persistent kernel differs from its staged sequence "
             f"(max |d| {float((a - b).abs().max()):.3e})")


def phase_lm_kernels(torch, datasets, from_dataset, lm, gk, tour, state):
    log("== phase 9: LM kernels against their plain twins, manhattan(260)")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.ops import pcg_kernel as pk
    from graphslam_tpu_torch.slam.pipeline import _solve_buckets, graph_view

    dev = torch.device("cuda")
    data = datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)
    g = from_dataset(data, device=dev)
    p0 = torch.from_numpy(data["poses"]).to(dev)
    lm_err, k3_err = 0.0, 0.0

    kern = gk.GnKernel(p0, g, 1.0, 4, cg_max=25, lm=True)
    e = rel_err(kern.chi2(p0)[0], gk.chi2_reference(p0, kern.pk, 1.0))
    log(f"  K1-LM cost pass (Huber 1.0): rel err {e:.3e} (tol {TOL_COST_REL})")
    if not e <= TOL_COST_REL:
        fail(f"the LM cost pass differs from its twin: {e}")
    for levels in (4, None):
        e, ce, ks, rs = _lm_pair(torch, gk, p0, g, huber_delta=1.0, pcr_levels=levels)
        _check_lm_pair(f"5 Huber iterations, pcr_levels={levels}", e, ce, ks, rs)
        lm_err = max(lm_err, e)
        _persistent_bitwise(torch, gk.GnKernel, p0, g, f"K1-LM 5 Huber steps, pcr_levels="
                            f"{levels}", levels=levels, huber=1.0, lm_steps=5)

    sysm = lm._linearized_system(p0, g, SolverConfig(use_huber_on_loops=True))
    for lam in (0.0, 1e-3):
        e, ea = _k3_pair(torch, pk, sysm, lam, g.chain_prefix)
        k3_err = max(k3_err, ea)
        log(f"  K3 at lam {lam}: rel err {e:.3e} (tol {TOL_CG_REL})")
        if not e <= TOL_CG_REL:
            fail(f"K3 differs from its twin at lam {lam}: {e}")
        _k3_bitwise(torch, pk, sysm, lam, g.chain_prefix, f"manhattan(260), lam {lam}")

    cfg = SolverConfig(mode="pcg_fused", max_iterations=5, cg_max_iterations=25,
                       use_huber_on_loops=True)
    out = lm._lm_loop(p0, g, cfg, "pcg_fused")
    ref = lm._lm_loop(p0.cpu(), g.to("cpu"), cfg, "pcg_fused")  # the twin runs on the CPU
    e = wrapped_max(out.poses.cpu(), ref.poses)
    log(f"  5 iterations of _lm_loop(pcg_fused), K3 vs twin: wrapped max err {e:.3e} "
        f"(tol {TOL_LM_POSES}); iterations {int(out.iterations)} vs {int(ref.iterations)}")
    if not (e <= TOL_LM_POSES and int(out.iterations) == int(ref.iterations)):
        fail(f"_lm_loop through K3 differs from the loop through the twin: {e}")

    cfg_o = tour["cfg"]
    nkf = int(state.num_kf)
    B = next(b for b in _solve_buckets(cfg_o.max_keyframes, cfg_o.solve_bucket_min) if b >= nkf)
    go = graph_view(state, cfg_o, B)
    po = state.kf_poses[:B]
    so = lm._linearized_system(po, go, SolverConfig())
    c = go.chain_prefix
    e, ea = _k3_pair(torch, pk, so, 0.0, c)
    k3_err = max(k3_err, ea)
    A = so.Aij[min(c, B - 1):]
    live = pk.live_loops(A)
    li, lj = (so.edges[min(c, B - 1):, k].to(torch.int32) for k in (0, 1))
    ptr, _ = gk.edge_csr(li, lj, live, B)
    n_live, n_mask = int(live.sum()), int(go.edge_mask[c:].sum())
    log(f"  K3 on the replay's online graph (bucket {B}, {A.shape[0]} loop slots, {n_live} with "
        f"a nonzero block, {n_mask} unmasked): rel err {e:.3e} (tol {TOL_CG_REL}); CSR entries "
        f"{int(ptr[-1])}")
    if not e <= TOL_CG_REL:
        fail(f"K3 on the online graph differs from its twin: {e}")
    _k3_bitwise(torch, pk, so, 0.0, c, f"on the replay's online graph (bucket {B})")
    if not (int(ptr[-1]) == 2 * n_live and torch.equal(live, go.edge_mask[c:])):
        fail("K3's CSR does not hold exactly the live loop slots")
    return lm_err, k3_err


def phase_lm_main(torch, datasets, from_dataset, chi2, metrics, lm, gk):
    log("== phase 10: m3500 LM main paths on cuda")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.ops import pcg_kernel as pk

    dev = torch.device("cuda")
    data = datasets.m3500()
    g = from_dataset(data, device=dev)
    p0 = torch.from_numpy(data["poses"]).to(dev)
    gt = torch.from_numpy(data["gt"]).to(dev)
    ate0 = float(metrics.ate(p0, gt))
    # scripts/bench_all.py's LM config; edge_tile and hvp_splits are TPU knobs
    cfg_k1 = SolverConfig(mode="gn_fused", cg_max_iterations=25, use_huber_on_loops=True,
                          max_iterations=50, pcr_levels=4, edge_tile=512, hvp_splits=1)
    cfg_k3 = SolverConfig(mode="pcg_fused", cg_max_iterations=25, use_huber_on_loops=True,
                          max_iterations=50)
    out = {}
    for name, cfg, counter, ref in (("K1-LM", cfg_k1, gk.fused_lm_solve, JAX_LM["fused"]),
                                    ("_lm_loop/K3", cfg_k3, pk.fused_pcg_solve, JAX_LM["loop"])):
        counter.launches = 0
        st = lm.lm_solve(p0, g, cfg)
        st2 = lm.lm_solve(p0, g, cfg)
        torch.cuda.synchronize()
        launches = counter.launches
        if launches <= 0:
            fail(f"the {name} main path did not launch its kernel")
        if not torch.isfinite(st.poses).all():
            fail(f"{name}: m3500 poses are not finite")
        ate, err = float(metrics.ate(st.poses, gt)), float(st.error)
        log(f"  {name}: {launches} kernel launches; chi2 {err:.2f} (JAX {ref['chi2']:.2f}), lam "
            f"{float(st.lam):.3g}, steps {int(st.iterations)} (JAX {ref['steps']}), converged "
            f"{bool(st.converged)}; ATE {ate0:.4f} -> {ate:.4f} (JAX {ref['ate']:.4f})")
        if not (ate < ATE_GATE_M and abs(ate - ref["ate"]) <= LM_ATE_BAND_M
                and abs(err - ref["chi2"]) <= TOL_CHI2_REL * ref["chi2"]):
            fail(f"{name}: m3500 LM gate failed (ATE {ate}, chi2 {err})")
        for a, b in zip(st, st2):
            if not torch.equal(a, b):
                fail(f"{name}: two runs differ")
        log(f"  {name}: two runs bitwise equal")
        out[name] = dict(launches=launches, ate=ate, chi2=err, steps=int(st.iterations))

    e, ce, ks, rs = _lm_pair(torch, gk, p0, g, huber_delta=1.0, pcr_levels=4)
    _check_lm_pair("m3500, 5 steps", e, ce, ks, rs)
    _persistent_bitwise(torch, gk.GnKernel, p0, g, "K1-LM m3500, 50 Huber steps", huber=1.0,
                        lm_steps=50)
    city = datasets.city10000()
    gc, pc = from_dataset(city, device=dev), torch.from_numpy(city["poses"]).to(dev)
    _persistent_bitwise(torch, gk.GnKernel, pc, gc, "K1-LM city10000, 5 Huber steps",
                        huber=1.0, lm_steps=5)
    sysm = lm._linearized_system(p0, g, cfg_k3)
    e3, ea3 = _k3_pair(torch, pk, sysm, cfg_k3.init_lambda, g.chain_prefix)
    log(f"  K3 at m3500 (lam {cfg_k3.init_lambda}): rel err {e3:.3e} (tol {TOL_CG_REL})")
    if not e3 <= TOL_CG_REL:
        fail(f"K3 differs from its twin at m3500: {e3}")
    _k3_bitwise(torch, pk, sysm, cfg_k3.init_lambda, g.chain_prefix, "at m3500")
    return p0, g, sysm, out, e, ea3


def _profile_launches(torch, fn, top: int = 0):
    """One profiled call of fn: ({source: (device launches, device ms)} for
    gn_kernel.cu, gn6_kernel.cu, torch ops and memcpy/memset, span ms).
    With top, logs the `top` kernels with the most device time."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        span = time.perf_counter() - t0
    groups = {"gn_kernel.cu": (0, 0.0), "gn6_kernel.cu": (0, 0.0), "cg_step.cu": (0, 0.0),
              "cg_step6.cu": (0, 0.0), "nccl": (0, 0.0), "torch ops": (0, 0.0),
              "memcpy/memset": (0, 0.0)}
    for e in prof.key_averages():
        dev_us = getattr(e, "self_device_time_total", 0.0) or 0.0
        if dev_us > 0 and str(getattr(e, "device_type", "")).endswith("CUDA"):
            g = ("gn_kernel.cu" if "GnProblem" in e.key else "gn6_kernel.cu"
                 if "Gn6Problem" in e.key else "cg_step.cu" if "CgProblem" in e.key
                 else "cg_step6.cu" if "Cg6Problem" in e.key else "nccl" if "nccl" in e.key.lower() else "memcpy/memset"
                 if e.key.startswith(("Memcpy", "Memset")) else "torch ops")
            c0, d0 = groups[g]
            groups[g] = (c0 + e.count, d0 + dev_us / 1e3)
    if top:
        kern = [e for e in prof.key_averages()
                if str(getattr(e, "device_type", "")).endswith("CUDA")
                and (getattr(e, "self_device_time_total", 0.0) or 0.0) > 0]
        for e in sorted(kern, key=lambda e: -e.self_device_time_total)[:top]:
            m = re.search(r"(?:^|[^A-Za-z])((?:k6?|cg6?)_[a-z0-9_]+)", e.key)
            name = m.group(1) if m else e.key[:60]
            log(f"    {e.self_device_time_total / 1e3:9.3f} ms  {e.count:7d}x  "
                f"{e.self_device_time_total / e.count:8.2f} us each  {name}")
    return groups, span * 1e3


def _launches_per_call(torch, fn, tag: str, calls: int = 10):
    """Launches a call of fn over `calls` profiled calls: (host launch API
    calls -- cudaLaunchKernel / cudaLaunchKernelExC --, device kernels whose
    name holds `tag`), each divided by `calls`."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    host = dev = 0
    for e in prof.key_averages():
        if e.key in ("cudaLaunchKernel", "cudaLaunchKernelExC"):
            host += e.count
        elif tag in e.key and str(getattr(e, "device_type", "")).endswith("CUDA"):
            dev += e.count
    return host / calls, dev / calls


def _log_profile(name, groups, span, n_it):
    busy = sum(d for _, d in groups.values())
    log(f"  profiled {name}: span {span:.3f} ms, device busy {busy:.3f} ms"
        + (f", idle share {1.0 - busy / span:.3f}" if busy > 0 else
           " (the profiler saw no device time)"))
    for g, (count, dev_ms) in groups.items():
        log(f"    by source: {g:14s} {count / n_it:8.1f} launches an iteration, "
            f"{dev_ms:9.3f} device ms")
    return (1.0 - busy / span) if busy > 0 else None


def _count_syncs(torch, fn) -> int:
    import warnings

    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode("default")
    return sum("synchroniz" in str(w.message) for w in caught)


def phase_lm_timing(torch, lm, gk, card, p0, g, sysm, main):
    log("== phase 11: m3500 LM timing")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.ops import pcg_kernel as pk

    iters, out = 50, {}
    kw = dict(iterations=iters, cg_iters=25, huber_delta=1.0, pcr_levels=4)

    def kernel(p):
        return gk.fused_lm_solve(p, g, **kw)[0]

    def plain(p):
        return gk.fused_lm_solve_reference(p, g, **kw)[0]

    def gn(p):
        return gk.fused_gn_solve(p, g, iterations=iters, cg_iters=25, pcr_levels=4)

    # in turns: plain, LM, GN, GN, LM, plain (the host's speed varies)
    chain_k, chain_p = 10, 2
    t_plain_a = _time_solves(torch, plain, p0, 3, chain_p)
    t_lm_a = _time_solves(torch, kernel, p0, 3, chain_k)
    t_gn = min(_time_solves(torch, gn, p0, 3, chain_k) for _ in range(2))
    t_lm_b = _time_solves(torch, kernel, p0, 3, chain_k)
    t_plain_b = _time_solves(torch, plain, p0, 3, chain_p)
    out["lm_ms"] = 1e3 * min(t_lm_a, t_lm_b) / chain_k
    out["gn_ms"] = 1e3 * t_gn / chain_k
    out["lm_plain_ms"] = 1e3 * min(t_plain_a, t_plain_b) / chain_p
    log(f"  card: {card}")
    log(f"  K1-LM: {out['lm_ms']:.3f} ms per {iters}-iteration LM solve ({1e3 * t_lm_a / chain_k:.3f} "
        f"and {1e3 * t_lm_b / chain_k:.3f} in turns), {iters * 1e3 / out['lm_ms']:.1f} LM it/s; "
        f"K1's GN mode between them {out['gn_ms']:.3f} ms per {iters}-iteration GN solve")
    log(f"  plain twin on the card: {out['lm_plain_ms']:.3f} ms per solve "
        f"({1e3 * t_plain_a / chain_p:.3f} before, {1e3 * t_plain_b / chain_p:.3f} after), "
        f"{iters * 1e3 / out['lm_plain_ms']:.1f} LM it/s")

    cfg_k3 = SolverConfig(mode="pcg_fused", cg_max_iterations=25, use_huber_on_loops=True,
                          max_iterations=iters)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = lm.lm_solve(p0, g, cfg_k3)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, int(st.iterations)))
    sec, n_it = statistics.median(r[0] for r in runs), runs[0][1]
    out["loop_ms"] = 1e3 * sec
    out["loop_it_s"] = n_it / sec
    log(f"  _lm_loop(pcg_fused): {out['loop_ms']:.3f} ms for {n_it} iterations (median of 3), "
        f"{out['loop_it_s']:.1f} LM it/s")

    lam = torch.tensor(cfg_k3.init_lambda, device=p0.device)
    kern3 = pk.PcgKernel(*pk._chain_and_loops(sysm, lam, True, g.chain_prefix), 25)
    # in turns: staged, persistent, persistent, staged
    t_sa = _event_us(torch, kern3.staged, 50)
    t_k3a = _event_us(torch, kern3.solve, 100)
    t_k3b = _event_us(torch, kern3.solve, 100)
    t_sb = _event_us(torch, kern3.staged, 50)
    out["k3_us"] = min(t_k3a, t_k3b)
    out["k3_staged_us"] = min(t_sa, t_sb)
    host, dev = _launches_per_call(torch, kern3.solve, "GnProblem")
    host_s, dev_s = _launches_per_call(torch, kern3.staged, "GnProblem")
    out["k3_launches_per_call"] = host
    out["k3_staged_launches_per_call"] = host_s
    log(f"  K3 per call of its C entry (CUDA events, in turns): persistent {t_k3a:.2f} and "
        f"{t_k3b:.2f} us, staged gn_factor + gn_cg {t_sa:.2f} and {t_sb:.2f} us "
        f"({out['k3_staged_us'] / out['k3_us']:.2f}x); launches a call (profiler, 10 calls; "
        f"host launch calls / device kernels): {host:g} / {dev:g} persistent, {host_s:g} / "
        f"{dev_s:g} staged")
    if host != 1:
        fail(f"K3 made {host} launches a call, not 1")
    out["k3_wrapper_us"] = _event_us(torch, lambda: pk.fused_pcg_solve(
        sysm, lam, max_iters=25, chain_prefix=g.chain_prefix), 50)
    out["k3_plain_us"] = _event_us(torch, lambda: pk.fused_pcg_solve_reference(
        sysm, lam, max_iters=25, chain_prefix=g.chain_prefix), 5, warmup=1)
    log(f"  K3 at m3500 (exact PCR, K = 12, cg 25; CUDA events): {out['k3_us']:.2f} us per "
        f"call of the C entry on a prepared problem, {out['k3_wrapper_us']:.2f} us per "
        f"fused_pcg_solve (damping, chain blocks and CSR in torch included), "
        f"{out['k3_plain_us']:.2f} us for the twin")

    kern1 = gk.GnKernel(p0, g, 1.0, 4, cg_max=25, lm=True)
    out["redesigned"] = _redesigned_timing(
        torch, f"K1-LM m3500 ({iters} Huber steps)", kern1, p0,
        lambda: kern1.lm_solve(iters, 25, *LM_ARGS),
        lambda: kern1.lm_solve_staged(iters, 25, *LM_ARGS),
        "GnProblem", (("gn_kernel", "k_lm_persistent"),))
    groups, span = _profile_launches(torch, lambda: kernel(p0))
    out["lm_launches_per_it"] = groups["gn_kernel.cu"][0] / iters
    out["lm_idle_share"] = _log_profile(f"K1-LM solve ({iters} iterations)", groups, span, iters)
    cfg_10 = dataclasses.replace(cfg_k3, max_iterations=10)
    groups, span = _profile_launches(torch, lambda: lm.lm_solve(p0, g, cfg_10))
    out["loop_launches_per_it"] = sum(c for c, _ in groups.values()) / 10
    out["loop_idle_share"] = _log_profile("_lm_loop(pcg_fused), 10 iterations", groups, span, 10)
    s_loop = _count_syncs(torch, lambda: lm.lm_solve(p0, g, cfg_10))
    s_lm = _count_syncs(torch, lambda: kernel(p0))
    out["loop_syncs_per_it"] = s_loop / 10
    out["lm_syncs"] = s_lm
    log(f"  host synchronizations: _lm_loop(pcg_fused) {s_loop} over 10 iterations "
        f"({s_loop / 10:.2f} per iteration); one K1-LM solve {s_lm} (the wrapper's node-id "
        f"check; none inside the solve)")
    return out


def lm_cost(N: int, c: int, El: int, K: int, iters: int, cg: int):
    """Bytes and float32 operations of one fused LM solve: a GN solve's
    stages (gn_cost) plus, per iteration, the damping, the candidate's cost
    pass over every chain, loop and prior row (~120 operations each: two
    betweens, a log, a 3x3 product, a square) and the accept step."""
    nbytes, flops = gn_cost(N, c, El, K, iters, cg)
    per_it = 3 * N + 120 * (c + El + N) + 3 * N
    return nbytes + 16, flops + (iters + 1) * per_it


def pcg_cost(N: int, El: int, K: int, cg: int):
    """Bytes (D, U, b and the loop blocks with their endpoints read once, x
    written once) and float32 operations of one K3 solve: the K-level PCR
    factor, then cg + 1 rounds of H@p, PCR apply, Dinv and the dots."""
    nbytes = 36 * N + 36 * N + 12 * N + 36 * El + 8 * El + 12 * N
    per_cg = N * (54 + 36 * K + 18 + 10) + 72 * El
    return nbytes, 400 * K * N + (cg + 1) * per_cg


# ---------------------------------------------------------------------------
# SE(3): K4 (GN and LM modes) and K5
# ---------------------------------------------------------------------------


def pose_max(a, b) -> float:
    """Max |a - b| over (N, 12) SE(3) poses, every entry alike."""
    return float((a - b).double().abs().max())


def _se3_graphs(torch, datasets, from_dataset):
    dev = torch.device("cuda")
    out = []
    for name, data in (("sphere(10, 10)", datasets.sphere(n_rings=10, poses_per_ring=10, seed=1)),
                       ("garage", datasets.garage())):
        out.append((name, from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev)))
    return out


def _check(label, err, tol):
    log(f"  {label}: {err:.3e} (tol {tol})")
    if not err <= tol:
        fail(f"{label} differs from the plain twin: {err} > {tol}")


def phase_se3_kernels(torch, datasets, from_dataset, lm):
    log("== phase 12: SE(3) kernels (K4, K5) against their plain twins")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.ops import gn6_kernel as g6
    from graphslam_tpu_torch.ops import pcg6_kernel as p6

    errs = {"gn": 0.0, "lm": 0.0, "k5": 0.0}
    for name, g, p0 in _se3_graphs(torch, datasets, from_dataset):
        N, dev = p0.shape[0], p0.device
        log(f"  {name}: {N} poses, {g.chain_prefix} chain and {g.num_edges - g.chain_prefix} "
            f"loop edges")
        kern = g6.Gn6Kernel(p0, g, -1.0, None, cg_max=25)
        kern.system()
        sysm = g6.system_reference6(p0, kern.pk)
        torch.cuda.synchronize()
        for label, a, b in (("D", kern.D, sysm.D), ("U", kern.U, sysm.U), ("b", kern.b, sysm.b)):
            _check(f"{name} assembled {label}, rel", rel_err(a, b), TOL_ASSEMBLY_REL)
        kern.factor()
        factor = g6.pcr_factor_reference6(sysm.D, sysm.U, kern.K)
        gen = torch.Generator(device="cpu").manual_seed(0)
        v = torch.randn((N, 6), generator=gen).to(dev)
        _check(f"{name} PCR apply (K={kern.K}), rel", rel_err(kern.precond(v),
               gk.pcr_apply_reference(*factor, v)), TOL_PCR_REL)
        kern.cg(25)
        x_ref = gk.cg_reference(sysm, kern.pk, factor, 25)
        torch.cuda.synchronize()
        _check(f"{name} CG solve (25 it), rel", rel_err(kern.x, x_ref), TOL_CG_REL)

        E, c = g.num_edges, g.chain_prefix
        mask = g.edge_mask.clone()
        mask[E - 1] = False
        mask[c - 2] = False
        keep = torch.arange(E, device=dev) < c
        for label, gg, kw in (
            ("exact PCR", g, dict(pcr_levels=None)),
            ("pcr_levels=4", g, dict(pcr_levels=4)),
            ("chain-only", g.replace(edge_mask=g.edge_mask & keep), dict(pcr_levels=None)),
            ("masked", g.replace(edge_mask=mask), dict(pcr_levels=None)),
            ("warm + ramp", g, dict(pcr_levels=None, warm_start=True, cg_ramp=((3, 25), (2, 12)))),
        ):
            out = g6.fused_gn6_solve(p0, gg, iterations=5, cg_iters=25, **kw)
            ref = g6.fused_gn6_solve_reference(p0, gg, iterations=5, cg_iters=25, **kw)
            torch.cuda.synchronize()
            if not torch.isfinite(out).all():
                fail(f"K4 produced non-finite poses ({name}, {label})")
            e = pose_max(out, ref)
            errs["gn"] = max(errs["gn"], e)
            _check(f"{name} 5 GN iterations, {label}, max |d|", e, TOL_SE3_POSES)
            if label in ("chain-only", "masked", "warm + ramp"):
                warm = label == "warm + ramp"
                _persistent_bitwise(torch, g6.Gn6Kernel, p0, gg, f"K4 {name} {label}",
                                    levels=None, warm=warm,
                                    phases=((3, 25), (2, 12)) if warm else ((5, 25),))

        kern = g6.Gn6Kernel(p0, g, 1.0, None, cg_max=25, lm=True)
        _check(f"{name} K4-LM cost pass (Huber 1.0), rel",
               rel_err(kern.chi2(p0)[0], g6.chi2_reference6(p0, kern.pk, 1.0)), TOL_COST_REL)
        kw = dict(iterations=5, cg_iters=25, huber_delta=1.0)
        out = g6.fused_lm6_solve(p0, g, **kw)
        ref = g6.fused_lm6_solve_reference(p0, g, **kw)
        torch.cuda.synchronize()
        ks, rs = [float(t) for t in out[1:]], [float(t) for t in ref[1:]]
        e, ce = pose_max(out[0], ref[0]), abs(ks[0] - rs[0]) / abs(rs[0])
        errs["lm"] = max(errs["lm"], e)
        log(f"  {name} K4-LM 5 Huber steps: max |d| {e:.3e} (tol {TOL_SE3_LM_POSES}), chi2 "
            f"{ks[0]:.4f} vs {rs[0]:.4f} (rel {ce:.2e}, tol {TOL_CHI2_REL}), lam {ks[1]:.3g} vs "
            f"{rs[1]:.3g}, accepted {ks[2]:.0f} vs {rs[2]:.0f}, converged {ks[3]:.0f} vs "
            f"{rs[3]:.0f}")
        if not (torch.isfinite(out[0]).all() and e <= TOL_SE3_LM_POSES and ce <= TOL_CHI2_REL
                and ks[2:] == rs[2:]):
            fail(f"K4-LM on {name} differs from its plain twin")
        _persistent_bitwise(torch, g6.Gn6Kernel, p0, g, f"K4-LM {name}, 5 Huber steps",
                            levels=None, huber=1.0, lm_steps=5)

        sysm = lm._linearized_system(p0, g, SolverConfig(use_huber_on_loops=True))
        for lam in (0.0, 1e-3):
            x = p6.fused_pcg6_solve(sysm, lam, max_iters=25, chain_prefix=c)
            xr = p6.fused_pcg6_solve_reference(sysm, lam, max_iters=25, chain_prefix=c)
            torch.cuda.synchronize()
            if not torch.isfinite(x).all():
                fail("K5 produced a non-finite solution")
            errs["k5"] = max(errs["k5"], float((x - xr).abs().max()))
            _check(f"{name} K5 at lam {lam}, rel", rel_err(x, xr), TOL_CG_REL)
            kern5 = p6.Pcg6Kernel(*p6._chain_and_loops(sysm, torch.tensor(lam, device=dev), True,
                                                       c, T=6), 25)
            a, b, again = kern5.solve().clone(), kern5.staged().clone(), kern5.solve().clone()
            torch.cuda.synchronize()
            same = torch.equal(a, b) and torch.equal(a, again)
            log(f"  K5 {name} at lam {lam}: gn6_pcg (one launch) vs gn6_factor + gn6_cg, and "
                f"two calls: {'bitwise equal' if same else 'DIFFERENT'}")
            if not (same and torch.isfinite(a).all()):
                fail(f"K5 on {name} at lam {lam}: gn6_pcg differs from its staged sequence "
                     f"(max |d| {float((a - b).abs().max()):.3e})")
    return errs


def _se3_main(torch, datasets, from_dataset):
    dev = torch.device("cuda")
    out = {}
    for name, make in (("sphere2500", datasets.sphere2500), ("garage", datasets.garage)):
        data = make()
        out[name] = (from_dataset(data, device=dev), torch.from_numpy(data["poses"]).to(dev),
                     torch.from_numpy(data["gt"]).to(dev))
    return out


def _gate_se3(name, ate0, ate, err, ref, steps=None):
    log(f"  {name}: chi2 {err:.2f} (JAX {ref['chi2']:.2f}), ATE {ate0:.4f} -> {ate:.4f} (JAX "
        f"{ref['ate']:.4f})" + ("" if steps is None else f", steps {steps} (JAX {ref['steps']})"))
    if not (ate < SE3_ATE_GATE_M and abs(ate - ref["ate"]) <= LM_ATE_BAND_M
            and abs(err - ref["chi2"]) <= SE3_CHI2_REL * ref["chi2"]):
        fail(f"{name}: SE(3) gate failed (ATE {ate}, chi2 {err})")


def phase_se3_main(torch, graphs, chi2, metrics, lm):
    log("== phase 13: SE(3) main paths on cuda (sphere2500, garage)")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.ops import gn6_kernel as g6
    from graphslam_tpu_torch.ops import pcg6_kernel as p6

    out = {}
    # scripts/bench_all.py's configs; edge_tile and hvp_splits are TPU knobs
    for name, tile in (("sphere2500", 512), ("garage", 256)):
        g, p0, gt = graphs[name]
        cfg = SolverConfig(mode="gn_fused", cg_max_iterations=25, max_iterations=80,
                           edge_tile=tile, hvp_splits=1)
        g6.fused_gn6_solve.launches = 0
        res = lm._gn_loop(p0, g, cfg, "gn_fused", 20)
        res2 = lm._gn_loop(p0, g, cfg, "gn_fused", 20)
        torch.cuda.synchronize()
        launches = g6.fused_gn6_solve.launches
        log(f"  {name} GN: fused_gn6_solve launches in the path: {launches}")
        if launches <= 0:
            fail(f"the {name} main path did not launch K4")
        if not torch.isfinite(res).all():
            fail(f"{name} poses are not finite")
        _gate_se3(f"{name} GN (20 iterations, cg 25, exact PCR)", float(metrics.ate(p0, gt)),
                  float(metrics.ate(res, gt)), float(chi2(res, g)), JAX_SE3[f"{name}_gn"])
        if not torch.equal(res, res2):
            fail(f"{name}: two runs differ: max {float((res - res2).abs().max())}")
        log(f"  {name} GN: two runs bitwise equal")
        out[name] = dict(launches=launches)
        _persistent_bitwise(torch, g6.Gn6Kernel, p0, g, f"K4 {name}, 20 iterations",
                            levels=None, phases=((20, 25),))

    g, p0, gt = graphs["sphere2500"]
    a = g6.fused_gn6_solve(p0, g, iterations=5, cg_iters=25)
    b = g6.fused_gn6_solve_reference(p0, g, iterations=5, cg_iters=25)
    torch.cuda.synchronize()
    out["sphere2500_err"] = pose_max(a, b)
    _check("sphere2500 5 GN iterations kernel vs twin, max |d|", out["sphere2500_err"],
           TOL_SE3_POSES)

    g, p0, gt = graphs["garage"]
    for mode, counter in (("gn_fused", g6.fused_lm6_solve), ("pcg_fused", p6.fused_pcg6_solve)):
        cfg = SolverConfig(mode=mode, cg_max_iterations=25, max_iterations=20,
                           use_huber_on_loops=True)
        counter.launches = 0
        st = lm.lm_solve(p0, g, cfg)
        st2 = lm.lm_solve(p0, g, cfg)
        torch.cuda.synchronize()
        launches = counter.launches
        log(f"  garage LM, mode {mode}: {counter.__name__} launches in the path: {launches}; lam "
            f"{float(st.lam):.3g}, converged {bool(st.converged)}")
        if launches <= 0:
            fail(f"the garage LM path in mode {mode} did not launch its kernel")
        if not torch.isfinite(st.poses).all():
            fail(f"garage LM ({mode}): poses are not finite")
        ate, err = float(metrics.ate(st.poses, gt)), float(st.error)
        _gate_se3(f"garage LM ({mode}, 20 steps, Huber 1.0)", float(metrics.ate(p0, gt)), ate, err,
                  JAX_SE3["garage_lm"], int(st.iterations))
        for x, y in zip(st, st2):
            if not torch.equal(x, y):
                fail(f"garage LM ({mode}): two runs differ")
        log(f"  garage LM ({mode}): two runs bitwise equal")
        if mode == "gn_fused":
            _persistent_bitwise(torch, g6.Gn6Kernel, p0, g, "K4-LM garage, 20 Huber steps",
                                levels=None, huber=1.0, lm_steps=20)
        out[f"garage_lm_{mode}"] = dict(launches=launches, ate=ate, chi2=err,
                                        steps=int(st.iterations))
    return out


def phase_se3_timing(torch, card, graphs, lm):
    log("== phase 14: SE(3) timing")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.ops import gn6_kernel as g6
    from graphslam_tpu_torch.ops import pcg6_kernel as p6

    iters, out = 20, {}
    log(f"  card: {card}")
    for name in ("sphere2500", "garage"):
        g, p0, _ = graphs[name]

        def kernel(p):
            return g6.fused_gn6_solve(p, g, iterations=iters, cg_iters=25)

        def plain(p):
            return g6.fused_gn6_solve_reference(p, g, iterations=iters, cg_iters=25)

        # in turns: plain, kernel, kernel, plain (the host's speed varies)
        chain_k, chain_p = 5, 1
        t_pa = _time_solves(torch, plain, p0, 3, chain_p)
        t_ka = _time_solves(torch, kernel, p0, 3, chain_k)
        t_kb = _time_solves(torch, kernel, p0, 3, chain_k)
        t_pb = _time_solves(torch, plain, p0, 3, chain_p)
        ms_k = 1e3 * min(t_ka, t_kb) / chain_k
        ms_p = 1e3 * min(t_pa, t_pb) / chain_p
        out[f"{name}_ms"], out[f"{name}_plain_ms"] = ms_k, ms_p
        log(f"  {name} GN ({iters} iterations, cg 25, exact PCR): K4 {ms_k:.3f} ms per solve "
            f"({1e3 * t_ka / chain_k:.3f} and {1e3 * t_kb / chain_k:.3f} in turns), "
            f"{iters * 1e3 / ms_k:.1f} GN it/s; twin on the card {ms_p:.3f} ms "
            f"({1e3 * t_pa / chain_p:.3f} before, {1e3 * t_pb / chain_p:.3f} after), "
            f"{iters * 1e3 / ms_p:.1f} GN it/s")

    g, p0, _ = graphs["garage"]
    kw = dict(iterations=iters, cg_iters=25, huber_delta=1.0)

    def lm_kernel(p):
        return g6.fused_lm6_solve(p, g, **kw)[0]

    def lm_plain(p):
        return g6.fused_lm6_solve_reference(p, g, **kw)[0]

    t_pa = _time_solves(torch, lm_plain, p0, 3, 1)
    t_ka = _time_solves(torch, lm_kernel, p0, 3, 5)
    t_kb = _time_solves(torch, lm_kernel, p0, 3, 5)
    t_pb = _time_solves(torch, lm_plain, p0, 3, 1)
    out["lm_ms"], out["lm_plain_ms"] = 1e3 * min(t_ka, t_kb) / 5, 1e3 * min(t_pa, t_pb)
    log(f"  garage K4-LM ({iters} steps, cg 25, Huber): {out['lm_ms']:.3f} ms per solve "
        f"({1e3 * t_ka / 5:.3f} and {1e3 * t_kb / 5:.3f} in turns), "
        f"{iters * 1e3 / out['lm_ms']:.1f} LM it/s; twin {out['lm_plain_ms']:.3f} ms")
    cfg5 = SolverConfig(mode="pcg_fused", cg_max_iterations=25, max_iterations=iters,
                        use_huber_on_loops=True)
    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        st = lm.lm_solve(p0, g, cfg5)
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0, int(st.iterations)))
    sec, n_it = statistics.median(r[0] for r in runs), runs[0][1]
    out["loop_ms"], out["loop_it_s"] = 1e3 * sec, n_it / sec
    log(f"  garage _lm_loop(pcg_fused): {out['loop_ms']:.3f} ms for {n_it} iterations (median of "
        f"3), {out['loop_it_s']:.1f} LM it/s")

    sysm = lm._linearized_system(p0, g, cfg5)
    lam = torch.tensor(cfg5.init_lambda, device=p0.device)
    kern5 = p6.Pcg6Kernel(*p6._chain_and_loops(sysm, lam, True, g.chain_prefix, T=6), 25)
    # in turns: staged, one launch, one launch, staged
    t_sa = _event_us(torch, kern5.staged, 20)
    t_na = _event_us(torch, kern5.solve, 50)
    t_nb = _event_us(torch, kern5.solve, 50)
    t_sb = _event_us(torch, kern5.staged, 20)
    out["k5_us"], out["k5_staged_us"] = min(t_na, t_nb), min(t_sa, t_sb)
    host, dev_n = _launches_per_call(torch, kern5.solve, "Gn6Problem")
    host_s, dev_s = _launches_per_call(torch, kern5.staged, "Gn6Problem")
    out["k5_launches_per_call"], out["k5_staged_launches_per_call"] = host, host_s
    out["k5_ptxas"] = {"k6_pcg_wide": _ptxas("gn6_kernel", "k6_pcg_wide")}
    regs, spill = out["k5_ptxas"]["k6_pcg_wide"]
    log(f"  K5 at garage (exact PCR, K = {math.ceil(math.log2(p0.shape[0]))}, cg 25), C entries "
        f"in turns (CUDA events): gn6_pcg (one launch) {t_na:.2f} and {t_nb:.2f} us, staged "
        f"gn6_factor + gn6_cg {t_sa:.2f} and {t_sb:.2f} us ({out['k5_staged_us'] / out['k5_us']:.2f}x); "
        f"launches a call (profiler, 10 calls; host launch calls / device kernels): {host:g} / "
        f"{dev_n:g}, staged {host_s:g} / {dev_s:g}; ptxas k6_pcg_wide {regs} registers, {spill} "
        f"bytes spill stores")
    if host != 1:
        fail(f"K5 made {host} launch calls a call, not 1")

    def wrapper():
        return p6.fused_pcg6_solve(sysm, lam, max_iters=25, chain_prefix=g.chain_prefix)

    def wrapper_staged():
        solve = p6.Pcg6Kernel.solve
        p6.Pcg6Kernel.solve = p6.Pcg6Kernel.staged
        try:
            return wrapper()
        finally:
            p6.Pcg6Kernel.solve = solve
    t_sa = _event_us(torch, wrapper_staged, 20)
    t_na = _event_us(torch, wrapper, 20)
    t_nb = _event_us(torch, wrapper, 20)
    t_sb = _event_us(torch, wrapper_staged, 20)
    out["k5_wrapper_us"], out["k5_wrapper_staged_us"] = min(t_na, t_nb), min(t_sa, t_sb)
    out["k5_plain_us"] = _event_us(torch, lambda: p6.fused_pcg6_solve_reference(
        sysm, lam, max_iters=25, chain_prefix=g.chain_prefix), 3, warmup=1)
    log(f"  K5 through fused_pcg6_solve (the wrapper's torch preparation included; in turns): "
        f"{t_na:.2f} and {t_nb:.2f} us, with the staged sequence {t_sa:.2f} and {t_sb:.2f} us; "
        f"the twin {out['k5_plain_us']:.2f} us")

    entries = (("gn6_kernel", "k6_gn_wide"),)
    for name in ("sphere2500", "garage"):
        g, p0, _ = graphs[name]
        kern = g6.Gn6Kernel(p0, g, -1.0, None, cg_max=25)
        out[f"{name}_redesigned"] = _redesigned_timing(
            torch, f"K4 {name} GN ({iters} iterations)", kern, p0,
            lambda: kern.solve(((iters, 25),), False),
            lambda: kern.solve_staged(((iters, 25),), False), "Gn6Problem", entries, reps=3)
    g, p0, _ = graphs["garage"]
    kern = g6.Gn6Kernel(p0, g, 1.0, None, cg_max=25, lm=True)
    out["lm_redesigned"] = _redesigned_timing(
        torch, f"K4-LM garage ({iters} Huber steps)", kern, p0,
        lambda: kern.lm_solve(iters, 25, *LM_ARGS),
        lambda: kern.lm_solve_staged(iters, 25, *LM_ARGS), "Gn6Problem",
        (("gn6_kernel", "k6_lm_wide"),), reps=3)
    groups, span = _profile_launches(torch, lambda: lm_kernel(p0))
    out["lm_idle_share"] = _log_profile(f"garage K4-LM solve through fused_lm6_solve ({iters} "
                                        f"steps)", groups, span, iters)

    g, p0, _ = graphs["sphere2500"]
    groups, span = _profile_launches(torch, lambda: g6.fused_gn6_solve(p0, g, iterations=iters,
                                                                       cg_iters=25), top=8)
    out["gn_launches_per_it"] = groups["gn6_kernel.cu"][0] / iters
    out["gn_idle_share"] = _log_profile(f"sphere2500 K4 GN solve ({iters} iterations)", groups,
                                        span, iters)
    g, p0, _ = graphs["garage"]
    cfg10 = dataclasses.replace(cfg5, max_iterations=10)
    groups, span = _profile_launches(torch, lambda: lm.lm_solve(p0, g, cfg10))
    out["loop_launches_per_it"] = sum(c for c, _ in groups.values()) / 10
    out["loop_idle_share"] = _log_profile("garage _lm_loop(pcg_fused), 10 iterations", groups,
                                          span, 10)
    return out


def gn6_cost(N: int, c: int, El: int, K: int, iters: int, cg: int):
    """Bytes (inputs read once, poses written once) and float32 operations
    of one fused SE(3) GN solve, counted from the kernel's stages: ~3500
    operations to linearize an edge (two betweens, the SO(3) log, Jr^-1
    with Q, Ad, whitening and the three 6x6 products JiT Ji, JiT Jj,
    JjT Jj), ~1500 to assemble a node with its prior, ~2400 per node and
    PCR level (two 6x6 inverses, four 6x6 products), ~250 to retract."""
    nbytes = 4 * (12 * N + 48 * c + 48 * N + 2 * El + 48 * El + 12 * N)
    per_cg = N * (72 + 144 + 144 * K + 72 + 30) + 144 * El
    per_gn = 3500 * (c + El) + 1500 * N + 2400 * K * N + (cg + 1) * per_cg + 250 * N
    return nbytes, iters * per_gn


def lm6_cost(N: int, c: int, El: int, K: int, iters: int, cg: int):
    """gn6_cost plus, per LM iteration, the damping and the candidate's cost
    pass (~600 operations a chain, loop or prior row: two betweens, the
    log, a 6x6 product and a square)."""
    nbytes, flops = gn6_cost(N, c, El, K, iters, cg)
    return nbytes + 16, flops + (iters + 1) * (600 * (c + El + N) + 6 * N)


def pcg6_cost(N: int, El: int, K: int, cg: int):
    """Bytes (D, U, b and the loop blocks with their endpoints read once, x
    written once) and float32 operations of one K5 solve."""
    nbytes = 4 * (36 * N + 36 * N + 6 * N + 36 * El + 2 * El + 6 * N)
    per_cg = N * (72 + 144 + 144 * K + 72 + 30) + 144 * El
    return nbytes, 2400 * K * N + (cg + 1) * per_cg


# ---------------------------------------------------------------------------
# The distributed SE(2) family: K6a-c on torch.distributed
# ---------------------------------------------------------------------------


def _k6_two_ranks(cs, gk, g, p0, huber=-1.0):
    """Two ranks' Shards in one process: half the loop edges each, the chain
    weighted 1 on rank 0 and 0 on rank 1, K = 4."""
    pk = gk.pack_graph(g, p0.shape[0])
    half = pk.El // 2
    return [cs.make_shard(pk, 0, half, 4, 1.0, huber),
            cs.make_shard(pk, half, pk.El, 4, 0.0, huber)]


def _k_sequence(torch, cs, shs, p0, lam, passes, kernel: bool, sfx: str = "",
                staged: bool = False, staged_setup: bool = False):
    """K6a (K7a with sfx "6" and cs parallel/cg_step6.py), the payloads
    summed (the all-reduce), K6b and `passes` K6c passes on two ranks,
    through the kernels or the twins (with staged, K6c as its staged
    sequence, cg_step_staged; with staged_setup, K7b as gn_setup_staged);
    returns (per-rank payloads and Aij, rank 0's Setup, rank 0's carry
    after pass 1 and after the last)."""
    stage_ref, setup_ref, step_ref = (getattr(cs, f"{n}{sfx}_reference")
                                      for n in ("stage_a", "gn_setup", "cg_step"))
    step_kern = getattr(cs, f"cg_step{sfx}")
    if kernel:
        kerns = [sh.kernel() for sh in shs]
        outs = [k.stage_a(p0) for k in kerns]
        outs = [(pay.clone(), A.clone()) for pay, A in outs]
        reduced = outs[0][0] + outs[1][0]
        setups = [(k.gn_setup_staged if staged_setup else k.gn_setup)(reduced.clone(), p0, lam)
                  for k in kerns]
        step = lambda i, A, c: step_kern(shs[i], setups[i], kerns[i].Aij, c)  # noqa: E731
        if staged:
            step = lambda i, A, c: kerns[i].cg_step_staged(kerns[i].Aij, c)  # noqa: E731
    else:
        outs = [stage_ref(sh, p0) for sh in shs]
        reduced = outs[0][0] + outs[1][0]
        setups = [setup_ref(sh, reduced, p0, lam) for sh in shs]
        step = lambda i, A, c: step_ref(shs[i], setups[i], A, c)  # noqa: E731
    carries = ([k.cg_state(setups[0].b) for k in kerns] if kernel else
               [cs.cg_state(setups[0].b) for _ in shs])
    first = None
    for it in range(passes):
        for i, ((_, A), c) in enumerate(zip(outs, carries)):
            step(i, A, c)
        big = carries[0].big + carries[1].big
        for c in carries:
            c.big.copy_(big)
        if it == 0:
            first = cs.CgState(*(t.clone() for t in carries[0]))
    return outs, setups[0], first, carries[0]


def _k_family_checks(torch, cs, sfx, tag, graphs, two_ranks):
    """K6a-c (tag "K6", sfx "") or K7a-c (tag "K7", sfx "6") against their
    twins, two ranks in one process, on each (name, graph, poses) of
    `graphs`, without and with Huber; two kernel sequences bitwise equal.
    two_ranks(g, p0, huber) gives the two ranks' shards."""
    errs = {"stage_a": 0.0, "gn_setup": 0.0, "cg_step_1": 0.0, "cg_step_26": 0.0}
    lam = torch.tensor([1e-3], device=torch.device("cuda"))
    for name, g, p0 in graphs:
        for huber in (-1.0, 1.0):
            shs = two_ranks(g, p0, huber)
            ko, ks, k1, kn = _k_sequence(torch, cs, shs, p0, lam, 26, True, sfx)
            ro, rs, r1, rn = _k_sequence(torch, cs, shs, p0, lam, 26, False, sfx)
            torch.cuda.synchronize()
            label = f"{name}, Huber {huber}"
            e = max(rel_err(a, b) for (pa, Aa), (pb, Ab) in zip(ko, ro)
                    for a, b in ((pa, pb), (Aa, Ab)) if b.abs().max() > 0)
            _check(f"{label}: {tag}a payload and Aij of both ranks, max rel err", e,
                   TOL_K6_ASSEMBLY_REL)
            errs["stage_a"] = max(errs["stage_a"], e)
            e_db = max(rel_err(ks.D, rs.D), rel_err(ks.b, rs.b))
            _check(f"{label}: {tag}b damped D and b, max rel err", e_db, TOL_K6_ASSEMBLY_REL)
            e_f = max(rel_err(ks.A, rs.A), rel_err(ks.G, rs.G), rel_err(ks.Dinv, rs.Dinv))
            _check(f"{label}: {tag}b PCR factor (A, G, Dinv), max rel err", e_f, TOL_PCR_REL)
            errs["gn_setup"] = max(errs["gn_setup"], e_db, e_f)
            for key, kc, rc, tol in (("cg_step_1", k1, r1, TOL_PCR_REL),
                                     ("cg_step_26", kn, rn, TOL_CG_REL)):
                e = max([rel_err(getattr(kc, f), getattr(rc, f)) for f in ("x", "r", "p", "cap",
                                                                             "big")
                         if getattr(rc, f).abs().max() > 0] + [rel_err(kc.scal[:2], rc.scal[:2])])
                _check(f"{label}: {tag}c state after {key.split('_')[-1]} passes, max rel err",
                       e, tol)
                errs[key] = max(errs[key], e)
        _, _, _, again = _k_sequence(torch, cs, shs, p0, lam, 26, True, sfx)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(kn, again)):
            fail(f"{name}: two {tag} sequences differ")
        log(f"  {name}: two {tag} sequences ({tag}a, {tag}b, 26 {tag}c passes) bitwise equal")
    return errs


def phase_k6_kernels(torch, datasets, from_dataset):
    log("== phase 15: K6a-c against their twins, two ranks in one process "
        "(manhattan(260), m3500)")
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.parallel import cg_step as cs

    dev = torch.device("cuda")
    graphs = []
    for name, data in (("manhattan(260)", datasets.manhattan(n_poses=260, loop_prob=0.25, seed=0)),
                       ("m3500", datasets.m3500())):
        graphs.append((name, from_dataset(data, device=dev),
                       torch.from_numpy(data["poses"]).to(dev)))
    errs = _k_family_checks(torch, cs, "", "K6", graphs,
                            lambda g, p0, huber: _k6_two_ranks(cs, gk, g, p0, huber))
    # K6c, one persistent launch a pass, against the staged sequence it
    # replaced: the whole carry bitwise after 1 and 26 passes
    lam = torch.tensor([1e-3], device=dev)
    for name, g, p0 in graphs:
        for huber in (-1.0, 1.0):
            shs = _k6_two_ranks(cs, gk, g, p0, huber)
            _, _, k1, kn = _k_sequence(torch, cs, shs, p0, lam, 26, True)
            _, _, s1, sn = _k_sequence(torch, cs, shs, p0, lam, 26, True, staged=True)
            torch.cuda.synchronize()
            same = all(torch.equal(a, b) for x, y in ((k1, s1), (kn, sn)) for a, b in zip(x, y))
            log(f"  {name}, Huber {huber}: K6c persistent vs cg_step_staged, two ranks, carry "
                f"after 1 and 26 passes: {'bitwise equal' if same else 'DIFFERENT'}")
            if not same:
                fail(f"{name}: the persistent K6c differs from its staged sequence")
    # K6a and K6b, one persistent launch a call each, against the staged
    # sequences they replaced: both ranks' payloads, Aij and Setups
    for name, g, p0 in graphs:
        pk = gk.pack_graph(g, p0.shape[0])
        for label, cut, huber, lam_v in (("half the loop edges each, Huber -1.0, lam 0", pk.El // 2,
                                          -1.0, 0.0),
                                         ("half the loop edges each, Huber 1.0, lam 1e-3",
                                          pk.El // 2, 1.0, 1e-3),
                                         ("a chain-only rank 0, Huber 1.0, lam 1e-3", 0, 1.0,
                                          1e-3)):
            shs = [cs.make_shard(pk, 0, cut, 4, 1.0, huber),
                   cs.make_shard(pk, cut, pk.El, 4, 0.0, huber)]
            a, b, again = (_k6ab_outputs(torch, shs, p0, lam_v, staged)
                           for staged in (False, True, False))
            same = all(torch.equal(x, y) for x, y in zip(a, b))
            twice = all(torch.equal(x, y) for x, y in zip(a, again))
            log(f"  {name}, {label}: K6a/K6b (one launch) vs staged (stage_a_staged, "
                f"gn_setup_staged), both ranks' payloads, Aij and Setups: "
                f"{'bitwise equal' if same else 'DIFFERENT'}; two calls: "
                f"{'bitwise equal' if twice else 'DIFFERENT'}")
            if not (same and twice):
                fail(f"{name}, {label}: the persistent K6a/K6b differ from their staged "
                     f"sequences or from themselves")
    return errs


def _k6ab_outputs(torch, shs, p0, lam, staged: bool):
    """K6a on two ranks' shards, the payloads summed (the all-reduce), K6b
    on both ranks at lam: the persistent entries or (staged) their staged
    sequences; every output of both ranks, cloned."""
    kerns = [sh.kernel() for sh in shs]
    outs = [[t.clone() for t in (k.stage_a_staged if staged else k.stage_a)(p0)] for k in kerns]
    reduced = outs[0][0] + outs[1][0]
    lam_t = torch.tensor([lam], device=p0.device)
    outs += [[t.clone() for t in (k.gn_setup_staged if staged else k.gn_setup)(reduced, p0, lam_t)]
             for k in kerns]
    torch.cuda.synchronize()
    return [t for o in outs for t in o]


def _gate_dist(name, ate0, ate, err, ref, steps=None):
    log(f"  {name}: chi2 {err:.2f} (JAX {ref['chi2']:.2f}), ATE {ate0:.4f} -> {ate:.4f} (JAX "
        f"{ref['ate']:.4f})" + ("" if steps is None else f", accepted steps {steps} (JAX "
                                                          f"{ref['steps']})"))
    if not (ate < ATE_GATE_M and ate < 0.5 * ate0 and abs(ate - ref["ate"]) <= LM_ATE_BAND_M
            and abs(err - ref["chi2"]) <= TOL_CHI2_REL * ref["chi2"]
            and (steps is None or steps == ref["steps"])):
        fail(f"{name}: gate failed (ATE {ate}, chi2 {err}, steps {steps})")


def _launch_counts(fns, zero=False):
    """{name: launches} of the wrappers fns, set to 0 first with zero."""
    if zero:
        for f in fns:
            f.launches = 0
    return {f.__name__: f.launches for f in fns}


def phase_dist_main(torch, datasets, from_dataset, chi2, metrics):
    log("== phase 16: the distributed main paths on cuda, m3500, world size 1 over NCCL")
    import torch.distributed as tdist
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.parallel import (
        cg_step as cs, dist_fused_gn_solve, dist_fused_lm_solve, dist_gn_solve, make_mesh,
        shard_graph)

    dev = torch.device("cuda")
    k6 = (cs.stage_a, cs.gn_setup, cs.cg_step)
    data = datasets.m3500()
    g = from_dataset(data, device=dev)
    p0 = torch.from_numpy(data["poses"]).to(dev)
    gt = torch.from_numpy(data["gt"]).to(dev)
    ate0 = float(metrics.ate(p0, gt))
    mesh = make_mesh()
    log(f"  mesh: {mesh.size} rank over {tdist.get_backend(mesh.group)} on {mesh.device}")
    out = {"mesh": mesh, "graph": (g, p0, gt)}

    # scripts/bench_all.py:207-248's cell without the CPU page windows;
    # edge_tile sets the loop-edge partition, hvp_splits is a TPU knob
    cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4, edge_tile=512, hvp_splits=1)
    iters = 200
    _launch_counts(k6, zero=True)
    res = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=iters)
    torch.cuda.synchronize()
    counts = _launch_counts(k6)
    log(f"  dist_fused_gn_solve ({iters} iterations): launches {counts}")
    if min(counts.values()) <= 0:
        fail("the dist_fused GN main path did not launch every K6 kernel")
    res2 = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=iters)
    torch.cuda.synchronize()
    if not torch.isfinite(res).all():
        fail("dist_fused GN poses are not finite")
    _gate_dist(f"dist_fused GN ({iters} iterations, cg 25, pcr_levels 4; JAX at hvp_splits 1)",
               ate0, float(metrics.ate(res, gt)), float(chi2(res, g)), JAX_DIST["gn"])
    if not torch.equal(res, res2):
        fail(f"dist_fused GN: two runs differ: max {float((res - res2).abs().max())}")
    log("  dist_fused GN: two runs bitwise equal")
    plain = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=iters, cg_kernel=False)
    _gate_dist(f"dist_fused GN plain path on the card ({iters} iterations)", ate0,
               float(metrics.ate(plain, gt)), float(chi2(plain, g)), JAX_DIST["gn"])
    a = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=5)
    b = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=5, cg_kernel=False)
    out["gn_err"] = wrapped_max(a, b)
    # 2e-4 holds on manhattan(300) (tests/test_torch_dist_fused.py); at m3500
    # from its drifted start the repo's kernel-vs-XLA GN tolerance (phase 4)
    _check("dist_fused GN 5 iterations, kernel path vs plain path, wrapped max", out["gn_err"],
           TOL_POSES_WRAPPED)
    out["gn_counts"] = counts

    # the K1-LM cell's settings (BASELINE config 2), 50 steps
    lm_cfg = SolverConfig(cg_max_iterations=25, use_huber_on_loops=True, pcr_levels=4,
                          edge_tile=512, hvp_splits=1)
    _launch_counts(k6, zero=True)
    lp, (lerr, llam, lacc) = dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=50)
    torch.cuda.synchronize()
    counts = _launch_counts(k6)
    log(f"  dist_fused_lm_solve (50 steps, Huber 1.0): launches {counts}, lam {float(llam):.3g}")
    if min(counts.values()) <= 0:
        fail("the dist_fused LM main path did not launch every K6 kernel")
    lp2, _ = dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=50)
    torch.cuda.synchronize()
    if not torch.isfinite(lp).all():
        fail("dist_fused LM poses are not finite")
    _gate_dist("dist_fused LM (50 steps, Huber 1.0; JAX at hvp_splits 1)", ate0,
               float(metrics.ate(lp, gt)), float(lerr), JAX_DIST["lm"], int(lacc))
    if not torch.equal(lp, lp2):
        fail("dist_fused LM: two runs differ")
    log("  dist_fused LM: two runs bitwise equal")
    pl, (perr, _, pacc) = dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=50, cg_kernel=False)
    _gate_dist("dist_fused LM plain path on the card (50 steps)", ate0, float(metrics.ate(pl, gt)),
               float(perr), JAX_DIST["lm"], int(pacc))
    a, _ = dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=5)
    b, _ = dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=5, cg_kernel=False)
    out["lm_err"] = wrapped_max(a, b)
    _check("dist_fused LM 5 steps, kernel path vs plain path, wrapped max", out["lm_err"],
           TOL_LM_POSES)
    out["lm_counts"] = counts

    # parallel/dist.py: plain torch, no kernel; scripts/bench_all.py:173-204
    dcfg = SolverConfig(mode="pcg", cg_max_iterations=50, cg_tol=1e-30)
    t0 = time.perf_counter()
    dres = dist_gn_solve(p0, shard_graph(g, mesh), mesh, dcfg, iterations=10)
    torch.cuda.synchronize()
    out["dist_gn_s"] = time.perf_counter() - t0
    _gate_dist(f"dist_gn_solve (pcg, cg 50, 10 iterations; {out['dist_gn_s']:.3f} s)", ate0,
               float(metrics.ate(dres, gt)), float(chi2(dres, g)), JAX_DIST["dist_gn"])
    return out


def _two_rank_worker(rank: int, port: int, out_path: str, root: str, se3: bool = False) -> None:
    """One of two gloo ranks on the one card: the kernel path on
    manhattan(1000) (se3: dist_fused6 on the garage), GN and LM; rank 0
    saves the poses."""
    sys.path.insert(0, root)
    import torch

    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.parallel import cg_step, cg_step6, multihost
    from graphslam_tpu_torch.parallel import dist_fused_gn_solve, dist_fused_lm_solve
    from graphslam_tpu_torch.parallel import dist_fused6_gn_solve, dist_fused6_lm_solve

    multihost.initialize(f"127.0.0.1:{port}", 2, rank, device="cuda", backend="gloo")
    mesh = multihost.global_mesh(device="cuda")
    problem = _two_rank_problem6 if se3 else _two_rank_problem
    gn, lm_ = problem(torch, datasets, from_dataset, mesh.device)
    g, p0, cfg, lm_cfg = gn + lm_
    gn_solve, lm_solve = ((dist_fused6_gn_solve, dist_fused6_lm_solve) if se3
                          else (dist_fused_gn_solve, dist_fused_lm_solve))
    a = gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    b, (err, lam, n_acc) = lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=True)
    torch.cuda.synchronize()
    launches = cg_step6.stage_a6.launches if se3 else cg_step.stage_a.launches
    sizes = torch.tensor([float(launches), float(mesh.size)])
    if multihost.is_coordinator():
        torch.save({"gn": a.cpu(), "lm": b.cpu(), "stats": torch.stack([err, lam, n_acc]).cpu(),
                    "el": torch.tensor(float(g.num_edges - g.chain_prefix)), "sizes": sizes},
                   out_path)
    torch.distributed.destroy_process_group()


def _two_rank_problem(torch, datasets, from_dataset, dev):
    """manhattan(1000, seed 5) (scripts/bench_all.py's quick size), tiles of
    32 loop edges so that both ranks hold loop edges."""
    from graphslam_tpu_torch.config import SolverConfig

    data = datasets.manhattan(n_poses=1000, seed=5)
    g = from_dataset(data, device=dev)
    p0 = torch.from_numpy(data["poses"]).to(dev)
    cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4, edge_tile=32)
    lm_cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4, edge_tile=32,
                          use_huber_on_loops=True)
    return (g, p0), (cfg, lm_cfg)


def _two_rank_problem6(torch, datasets, from_dataset, dev):
    """The garage in tiles of 64 loop edges (5 tiles: 3 on rank 0, 2 on
    rank 1), cg 25, exact PCR; LM with Huber 1.0."""
    from graphslam_tpu_torch.config import SolverConfig

    data = datasets.garage()
    g = from_dataset(data, device=dev)
    p0 = torch.from_numpy(data["poses"]).to(dev)
    cfg = SolverConfig(cg_max_iterations=25, edge_tile=64)
    lm_cfg = SolverConfig(cg_max_iterations=25, edge_tile=64, use_huber_on_loops=True)
    return (g, p0), (cfg, lm_cfg)


def _spawn_two_ranks(torch, se3: bool):
    """The two gloo ranks of _two_rank_worker on the one card; rank 0's
    saved results and the wall seconds."""
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    ctx = torch.multiprocessing.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        path = str(Path(tmp) / "two_ranks.pt")
        procs = [ctx.Process(target=_two_rank_worker, args=(r, port, path, str(ROOT), se3))
                 for r in range(2)]
        t0 = time.perf_counter()
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.kill()
            p.join()
        if hung or any(p.exitcode != 0 for p in procs):
            fail(f"two-rank run failed: exit codes {[p.exitcode for p in procs]}")
        return torch.load(path), time.perf_counter() - t0


def phase_two_ranks(torch, datasets, from_dataset, mesh):
    log("== phase 17: two gloo ranks on the one card (CUDA tensors), kernel path, "
        "manhattan(1000)")
    from graphslam_tpu_torch.parallel import dist_fused_gn_solve, dist_fused_lm_solve

    (g, p0), (cfg, lm_cfg) = _two_rank_problem(torch, datasets, from_dataset, mesh.device)
    one_gn = dist_fused_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    one_lm, one_st = dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=True)
    torch.cuda.synchronize()
    res, secs = _spawn_two_ranks(torch, se3=False)
    log(f"  two ranks ran in {secs:.1f} s; loop edges "
        f"{int(res['el'])} in tiles of {cfg.edge_tile}; rank 0 launched K6a "
        f"{int(res['sizes'][0])} times")
    # relative to the largest coordinate: only the order in which the ranks'
    # loop partials are summed differs, and at manhattan(1000)'s ~20 m that
    # is ~10 float32 ulps (1.81e-5 absolute between the twins at one and two
    # gloo ranks on the CPU)
    scale = float(one_gn[:, :2].abs().max())
    e_gn = wrapped_max(res["gn"].to(p0.device), one_gn) / scale
    e_lm = wrapped_max(res["lm"].to(p0.device), one_lm) / scale
    _check("two ranks vs one rank, 3 GN iterations, wrapped max over the largest coordinate",
           e_gn, TOL_MESH)
    _check("two ranks vs one rank, 3 LM steps, wrapped max over the largest coordinate", e_lm,
           TOL_MESH)
    if int(res["stats"][2]) != int(one_st[2]):
        fail(f"two ranks accepted {int(res['stats'][2])} LM steps, one rank {int(one_st[2])}")
    return max(e_gn, e_lm)


def stage_a_cost(N: int, c: int, El: int):
    """K6a: poses, chain and loop inputs and the CSR read once, the payload
    and the Aij stash written once; ~250 operations to linearize an edge
    (two betweens, the log, Jr^-1, Ad, whitening, three 3x3 products), ~60
    to assemble a node and 12 per loop-edge term it sums."""
    nbytes = 12 * N + 48 * c + 56 * El + 4 * (N + 1) + 8 * El + 84 * N + 36 * El
    return nbytes, 250 * (c + El) + 60 * N + 24 * El


def gn_setup_cost(N: int, K: int):
    """K6b: payload, poses, priors and lam read once; D, the K-level PCR
    factor, Dinv and b written once; ~150 operations for a node's prior and
    damping, ~400 per node and PCR level."""
    nbytes = 84 * N + 12 * N + 48 * N + 4 + 36 * N + 72 * K * N + 36 * N + 12 * N
    return nbytes, 150 * N + 400 * K * N


def cg_step_cost(N: int, El: int, K: int):
    """K6c, one pass: the carry, D, U, the PCR factor, Aij with its
    endpoints and the CSR read once; the carry written once; the update,
    the K-level PCR apply and Dinv, the direction, the chain and loop H@p
    and the three dots."""
    nbytes = (48 * N + 16 + 12 * N + 4 + 36 * N + 36 * N + 72 * K * N + 36 * N + 36 * El
              + 8 * El + 4 * (N + 1) + 8 * El + 48 * N + 16 + 12 * N + 4)
    return nbytes, N * (108 + 36 * K) + 72 * El


def phase_dist_timing(torch, card, main):
    log("== phase 18: distributed timing (m3500, world size 1 over NCCL)")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.parallel import cg_step as cs, dist_fused, dist_fused_gn_solve
    from graphslam_tpu_torch.solver import lm

    mesh, (g, p0, _) = main["mesh"], main["graph"]
    cfg = SolverConfig(mode="gn_fused", cg_max_iterations=25, pcr_levels=4, edge_tile=512,
                       hvp_splits=1)
    iters, out = 200, {}

    def k6(p):
        return dist_fused_gn_solve(p, g, mesh, cfg, iterations=iters)

    def k1(p):
        return lm._gn_loop(p, g, cfg, "gn_fused", iters)

    plain_iters = 20  # the plain path at ~15 GN it/s: a tenth of the solve

    def plain(p):
        return dist_fused_gn_solve(p, g, mesh, cfg, iterations=plain_iters, cg_kernel=False)

    class LocalMesh(type(mesh)):
        """The same rank without the collectives: what NCCL costs at world
        size 1, where an all-reduce adds nothing."""

        def all_reduce(self, t):
            return t

    local = LocalMesh(group=None, rank=0, size=1, device=mesh.device)

    def k6_local(p):
        return dist_fused_gn_solve(p, g, local, cfg, iterations=iters)

    # in turns: plain, K1, K6, K6 without collectives, K6, K1, plain (the
    # host's speed varies)
    t_pa = _time_solves(torch, plain, p0, 1, 1)
    t_1a = _time_solves(torch, k1, p0, 3, 2)
    t_6a = _time_solves(torch, k6, p0, 3, 2)
    t_6l = _time_solves(torch, k6_local, p0, 3, 2)
    t_6b = _time_solves(torch, k6, p0, 3, 2)
    t_1b = _time_solves(torch, k1, p0, 3, 2)
    t_pb = _time_solves(torch, plain, p0, 1, 1)
    out["k6_ms"] = 1e3 * min(t_6a, t_6b) / 2
    out["k6_local_ms"] = 1e3 * t_6l / 2
    out["k1_ms"] = 1e3 * min(t_1a, t_1b) / 2
    out["plain_ms"] = 1e3 * min(t_pa, t_pb) * iters / plain_iters
    log(f"  card: {card}")
    log(f"  dist_fused GN through K6 ({iters} iterations, cg 25, pcr_levels 4): "
        f"{out['k6_ms']:.3f} ms per solve ({1e3 * t_6a / 2:.3f} and {1e3 * t_6b / 2:.3f} in "
        f"turns), {iters * 1e3 / out['k6_ms']:.1f} GN it/s")
    log(f"  K1 (_gn_loop gn_fused, same config): {out['k1_ms']:.3f} ms per solve "
        f"({1e3 * t_1a / 2:.3f} and {1e3 * t_1b / 2:.3f}), {iters * 1e3 / out['k1_ms']:.1f} GN "
        f"it/s; the 1-device gap K6/K1 = {out['k6_ms'] / out['k1_ms']:.2f}x")
    log(f"  K6 without the collectives (the same rank, all-reduce skipped): "
        f"{out['k6_local_ms']:.3f} ms per solve, {iters * 1e3 / out['k6_local_ms']:.1f} GN it/s")
    log(f"  plain path on the card: {1e3 * t_pa:.3f} ms before, {1e3 * t_pb:.3f} after per "
        f"{plain_iters}-iteration solve, {iters * 1e3 / out['plain_ms']:.1f} GN it/s "
        f"({out['plain_ms']:.3f} ms per {iters} iterations)")

    sh = dist_fused._prepare(p0, g, mesh, -1.0, cfg.pcr_levels, cfg.edge_tile)
    kern = sh.kernel()
    lam = torch.zeros(1, device=p0.device)
    payload, Aij = kern.stage_a(p0)
    st = kern.gn_setup(payload, p0, lam)
    carry = kern.cg_state(st.b)
    # K6a and K6b, each C entry and each wrapper in turns with the staged
    # sequence it replaced: staged, one launch, one launch, staged (CUDA
    # events)
    import ctypes

    kern.prob.stream = torch.cuda.current_stream(p0.device).cuda_stream
    lib, prob = kern.lib, ctypes.byref(kern.prob)
    lib.cg_row_ctas.argtypes = [ctypes.c_longlong]
    rows = {"stage_a": max(sh.N, sh.c + sh.El), "gn_setup": sh.N}
    entries = {
        "stage_a": ("K6a", "cg_stage_a_persistent",
                    lambda: lib.cg_stage_a(prob), lambda: lib.cg_stage_a_staged(prob),
                    lambda: cs.stage_a(sh, p0), lambda: kern.stage_a_staged(p0)),
        "gn_setup": ("K6b", "cg_gn_setup_persistent",
                     lambda: lib.cg_gn_setup(prob, lam.data_ptr()),
                     lambda: lib.cg_gn_setup_staged(prob, lam.data_ptr()),
                     lambda: cs.gn_setup(sh, payload, p0, lam),
                     lambda: kern.gn_setup_staged(payload, p0, lam)),
    }
    for key, (tag, kname, new, old, wrap, wrap_old) in entries.items():
        for fn in (new, old):
            rc = fn()
            if rc:
                fail(f"{tag}: a C entry returned CUDA error {rc}")
        t_sa = _event_us(torch, old, 200)
        t_na = _event_us(torch, new, 200)
        t_nb = _event_us(torch, new, 200)
        t_sb = _event_us(torch, old, 200)
        w_sa = _event_us(torch, wrap_old, 200)
        w_na = _event_us(torch, wrap, 200)
        w_nb = _event_us(torch, wrap, 200)
        w_sb = _event_us(torch, wrap_old, 200)
        host, dev_n = _launches_per_call(torch, new, "CgProblem")
        host_s, dev_s = _launches_per_call(torch, old, "CgProblem")
        regs, spill = _ptxas("cg_step", kname)
        out[f"{key}_us"] = min(w_na, w_nb)
        ctas = lib.cg_row_ctas(rows[key])  # < 0: a cooperative grid
        out[f"{key}_entry"] = dict(us=min(t_na, t_nb), us_staged=min(t_sa, t_sb),
                                   us_wrapper_staged=min(w_sa, w_sb), launches=host,
                                   staged_launches=host_s, ptxas={kname: (regs, spill)},
                                   ctas=ctas)
        log(f"  {tag} at m3500 ({abs(ctas)} CTAs, {'a cooperative grid' if ctas < 0 else 'a cluster'}"
            f"), C entries in turns (CUDA events): cg_{key} (one launch) "
            f"{t_na:.2f} and {t_nb:.2f} us, staged {t_sa:.2f} and {t_sb:.2f} us "
            f"({min(t_sa, t_sb) / min(t_na, t_nb):.2f}x); wrappers in turns: {w_na:.2f} and "
            f"{w_nb:.2f} us, staged {w_sa:.2f} and {w_sb:.2f} us; launches a call (profiler, 10 "
            f"calls; host launch calls / device kernels): {host:g} / {dev_n:g}, staged "
            f"{host_s:g} / {dev_s:g}; ptxas {kname} {regs} registers, {spill} bytes spill "
            f"stores")
        if host != 1:
            fail(f"{tag} made {host} launch calls a call, not 1")
    # K6c in turns with the staged sequence it replaced: staged, persistent,
    # persistent, staged (through the wrapper, one pass a call)
    t_sa = _event_us(torch, lambda: kern.cg_step_staged(Aij, carry), 500)
    t_ka = _event_us(torch, lambda: cs.cg_step(sh, st, Aij, carry), 500)
    t_kb = _event_us(torch, lambda: cs.cg_step(sh, st, Aij, carry), 500)
    t_sb = _event_us(torch, lambda: kern.cg_step_staged(Aij, carry), 500)
    out["cg_step_us"] = min(t_ka, t_kb)
    out["cg_step_staged_us"] = min(t_sa, t_sb)
    host, dev = _launches_per_call(torch, lambda: cs.cg_step(sh, st, Aij, carry), "CgProblem")
    host_s, dev_s = _launches_per_call(torch, lambda: kern.cg_step_staged(Aij, carry),
                                       "CgProblem")
    out["cg_step_launches_per_pass"] = host
    out["cg_step_staged_launches_per_pass"] = host_s
    log(f"  K6c per pass (CUDA events, the wrapper included, in turns): persistent "
        f"{t_ka:.2f} and {t_kb:.2f} us, staged {t_sa:.2f} and {t_sb:.2f} us "
        f"({out['cg_step_staged_us'] / out['cg_step_us']:.2f}x); launches a pass (profiler, 10 "
        f"passes; host launch calls / device kernels): {host:g} / {dev:g} persistent, "
        f"{host_s:g} / {dev_s:g} staged")
    if host != 1:
        fail(f"K6c made {host} launches a pass, not 1")
    out["stage_a_plain_us"] = _event_us(torch, lambda: cs.stage_a_reference(sh, p0), 20)
    ref_pay, ref_A = cs.stage_a_reference(sh, p0)
    out["gn_setup_plain_us"] = _event_us(
        torch, lambda: cs.gn_setup_reference(sh, ref_pay, p0, lam), 10, warmup=1)
    ref_st = cs.gn_setup_reference(sh, ref_pay, p0, lam)
    ref_carry = cs.cg_state(ref_st.b)
    out["cg_step_plain_us"] = _event_us(
        torch, lambda: cs.cg_step_reference(sh, ref_st, ref_A, ref_carry), 50)
    big = torch.zeros(3 * sh.N + 1, device=p0.device)
    pay = torch.zeros(cs.payload_size(sh.N), device=p0.device)
    out["allreduce_big_us"] = _event_us(torch, lambda: mesh.all_reduce(big), 500)
    out["allreduce_payload_us"] = _event_us(torch, lambda: mesh.all_reduce(pay), 200)
    out["k6_launch_counts_per_call"] = (out["stage_a_entry"]["launches"],
                                        out["gn_setup_entry"]["launches"], host)
    log(f"  per call (CUDA events, the wrapper included): K6a {out['stage_a_us']:.2f} us, K6b "
        f"{out['gn_setup_us']:.2f} us, K6c {out['cg_step_us']:.2f} us; twins on the card "
        f"{out['stage_a_plain_us']:.2f}, {out['gn_setup_plain_us']:.2f}, "
        f"{out['cg_step_plain_us']:.2f} us")
    log(f"  all_reduce at world size 1 (NCCL): {out['allreduce_big_us']:.2f} us for the "
        f"[tile_Ap; s1] buffer ({3 * sh.N + 1} floats), {out['allreduce_payload_us']:.2f} us for "
        f"the payload ({cs.payload_size(sh.N)} floats)")

    n_it = 10
    k6 = (cs.stage_a, cs.gn_setup, cs.cg_step)
    _launch_counts(k6, zero=True)
    groups, span = _profile_launches(torch, lambda: dist_fused_gn_solve(
        p0, g, mesh, cfg, iterations=n_it), top=10)
    calls = _launch_counts(k6)
    out["launches_per_it"] = {k: c / n_it for k, (c, _) in groups.items()}
    out["idle_share"] = _log_profile(f"dist_fused GN through K6 ({n_it} iterations)", groups,
                                     span, n_it)
    per_call = out["k6_launch_counts_per_call"]
    per_it = sum(calls[f.__name__] * n for f, n in zip(k6, per_call)) / n_it
    out["cg_step_launches_per_it"] = per_it
    dev_it = out["launches_per_it"]["cg_step.cu"]
    log(f"  cg_step.cu launches a dist_fused GN iteration: {per_it:g} (wrapper calls {calls} "
        f"over {n_it} iterations times host launch calls a call {per_call}; K6a 1, K6b 1, 26 "
        f"K6c passes 1 each: 28; staged: 2 + {1 + sh.K} + 26 x {4 + sh.K} = "
        f"{2 + 1 + sh.K + 26 * (4 + sh.K)}); device kernels the profiler kept: {dev_it:.1f}")
    if per_it != 1 + 1 + 26 or dev_it > 1 + 1 + 26:
        fail(f"{per_it} cg_step.cu launches a dist_fused GN iteration ({dev_it} device "
             f"kernels), not 28")
    return out


# ---------------------------------------------------------------------------
# The distributed SE(3) family: K7a-c on torch.distributed
# ---------------------------------------------------------------------------


def _k7_two_ranks(cs6, g6, g, p0, huber=-1.0):
    """Two ranks' Shard6s in one process: half the loop edges each, the
    chain weighted 1 on rank 0 and 0 on rank 1, exact K = ceil(log2 N)."""
    from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for

    N = p0.shape[0]
    pk = g6.pack_graph6(g, N)
    K = pcr_levels_for(N, None)
    half = pk.El // 2
    return [cs6.make_shard6(pk, 0, half, K, 1.0, huber),
            cs6.make_shard6(pk, half, pk.El, K, 0.0, huber)]


def phase_k7_kernels(torch, graphs):
    log("== phase 19: K7a-c against their twins, two ranks in one process "
        "(sphere(10, 10), garage)")
    from graphslam_tpu_torch.ops import gn6_kernel as g6
    from graphslam_tpu_torch.parallel import cg_step6 as cs6

    errs = _k_family_checks(torch, cs6, "6", "K7", graphs,
                            lambda g, p0, huber: _k7_two_ranks(cs6, g6, g, p0, huber))
    # K7b and K7c, one persistent launch a call each, against the staged
    # sequences they replaced: the Setup and the whole carry after 1 and 26
    # passes bitwise (fresh shards each, so that no buffer is shared)
    lam = torch.tensor([1e-3], device=torch.device("cuda"))
    for name, g, p0 in graphs:
        for huber in (-1.0, 1.0):
            _, ks, k1, kn = _k_sequence(torch, cs6, _k7_two_ranks(cs6, g6, g, p0, huber), p0, lam,
                                        26, True, "6")
            ks = [t.clone() for t in ks]
            _, ss, s1, sn = _k_sequence(torch, cs6, _k7_two_ranks(cs6, g6, g, p0, huber), p0, lam,
                                        26, True, "6", staged=True, staged_setup=True)
            torch.cuda.synchronize()
            same_b = all(torch.equal(a, b) for a, b in zip(ks, ss))
            same_c = all(torch.equal(a, b) for x, y in ((k1, s1), (kn, sn)) for a, b in zip(x, y))
            log(f"  {name}, Huber {huber}: K7b gn_setup6 (one launch) vs gn_setup_staged, the "
                f"Setup: {'bitwise equal' if same_b else 'DIFFERENT'}; K7c cg_step6 (one launch) "
                f"vs cg_step_staged, two ranks, carry after 1 and 26 passes: "
                f"{'bitwise equal' if same_c else 'DIFFERENT'}")
            if not (same_b and same_c):
                fail(f"{name}: the persistent K7b or K7c differs from its staged sequence")
    for name, g, p0 in graphs:
        _k7a_bitwise(torch, cs6, g6, name, g, p0)
    return errs


def _k7a_bitwise(torch, cs6, g6, name, g, p0):
    """K7a, one launch a call, against the staged sequence it replaced
    (cg6_stage_a_staged), without and with Huber: both ranks' payloads and
    Aij stashes bitwise (fresh shards each), and two calls alike."""
    for huber in (-1.0, 1.0):
        runs = []
        for staged in (False, True, False):
            kerns = [sh.kernel() for sh in _k7_two_ranks(cs6, g6, g, p0, huber)]
            runs.append([t.clone() for k in kerns
                         for t in (k.stage_a_staged if staged else k.stage_a)(p0)])
        torch.cuda.synchronize()
        same = all(torch.equal(a, b) for a, b in zip(runs[0], runs[1]))
        twice = all(torch.equal(a, b) for a, b in zip(runs[0], runs[2]))
        log(f"  {name}, Huber {huber}: K7a stage_a6 (one launch) vs stage_a_staged, both ranks' "
            f"payloads and Aij: {'bitwise equal' if same else 'DIFFERENT'}; two calls: "
            f"{'bitwise equal' if twice else 'DIFFERENT'}")
        if not (same and twice):
            fail(f"{name}: the persistent K7a differs from its staged sequence or from itself")


def phase_dist6_main(torch, graphs, chi2, metrics, mesh):
    log("== phase 20: the distributed SE(3) main paths on cuda (sphere2500, garage), world size "
        "1 over NCCL")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.ops import gn6_kernel as g6
    from graphslam_tpu_torch.parallel import cg_step6 as cs6
    from graphslam_tpu_torch.parallel import dist_fused6_gn_solve, dist_fused6_lm_solve

    out, k7 = {}, (cs6.stage_a6, cs6.gn_setup6, cs6.cg_step6)
    # scripts/bench_all.py:251-283's cell without the CPU page windows, cut
    # from 80 to 20 iterations; edge_tile sets the loop-edge partition,
    # hvp_splits is a TPU knob
    cfg = SolverConfig(cg_max_iterations=25, edge_tile=256, hvp_splits=1)
    for name in ("sphere2500", "garage"):
        g, p0, gt = graphs[name]
        _launch_counts(k7, zero=True)
        res = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=20)
        torch.cuda.synchronize()
        counts = _launch_counts(k7)
        log(f"  {name} dist_fused6_gn_solve (20 iterations): launches {counts}")
        if min(counts.values()) <= 0:
            fail(f"the {name} dist_fused6 GN main path did not launch every K7 kernel")
        res2 = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=20)
        torch.cuda.synchronize()
        if not torch.isfinite(res).all():
            fail(f"{name} dist_fused6 GN poses are not finite")
        hs3 = JAX_DIST6[f"{name}_gn_hs3"]
        log(f"  JAX at hvp_splits 3: chi2 {hs3['chi2']:.2f}, ATE {hs3['ate']:.4f}")
        _gate_se3(f"{name} dist_fused6 GN (20 iterations, cg 25, exact PCR; JAX at hvp_splits 1)",
                  float(metrics.ate(p0, gt)), float(metrics.ate(res, gt)), float(chi2(res, g)),
                  JAX_DIST6[f"{name}_gn"])
        if not torch.equal(res, res2):
            fail(f"{name} dist_fused6 GN: two runs differ: max {float((res - res2).abs().max())}")
        log(f"  {name} dist_fused6 GN: two runs bitwise equal")
        a = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=5)
        b = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=5, cg_kernel=False)
        k4 = g6.fused_gn6_solve(p0, g, iterations=5, cg_iters=25)
        torch.cuda.synchronize()
        out[f"{name}_plain_err"], out[f"{name}_k4_err"] = pose_max(a, b), pose_max(a, k4)
        _check(f"{name} dist_fused6 GN 5 iterations, kernel path vs plain path, max |d|",
               out[f"{name}_plain_err"], TOL_SE3_POSES)
        _check(f"{name} dist_fused6 GN 5 iterations, kernel path vs K4, max |d|",
               out[f"{name}_k4_err"], TOL_SE3_POSES)
        out[f"{name}_counts"] = counts

    g, p0, gt = graphs["garage"]
    lm_cfg = SolverConfig(cg_max_iterations=25, edge_tile=256, hvp_splits=1,
                          use_huber_on_loops=True, huber_delta=1.0)
    _launch_counts(k7, zero=True)
    lp, (lerr, llam, lacc) = dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=20)
    torch.cuda.synchronize()
    counts = _launch_counts(k7)
    log(f"  garage dist_fused6_lm_solve (20 steps, Huber 1.0): launches {counts}, lam "
        f"{float(llam):.3g}")
    if min(counts.values()) <= 0:
        fail("the garage dist_fused6 LM main path did not launch every K7 kernel")
    lp2, _ = dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=20)
    torch.cuda.synchronize()
    if not torch.isfinite(lp).all():
        fail("garage dist_fused6 LM poses are not finite")
    ref = JAX_DIST6["garage_lm"]
    _gate_se3("garage dist_fused6 LM (20 steps, Huber 1.0; JAX at hvp_splits 1)",
              float(metrics.ate(p0, gt)), float(metrics.ate(lp, gt)), float(lerr), ref,
              int(lacc))
    if int(lacc) != ref["steps"]:
        fail(f"garage dist_fused6 LM accepted {int(lacc)} steps, JAX {ref['steps']}")
    if not torch.equal(lp, lp2):
        fail("garage dist_fused6 LM: two runs differ")
    log("  garage dist_fused6 LM: two runs bitwise equal")
    a, sa = dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=5)
    b, sb = dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=5, cg_kernel=False)
    k4 = g6.fused_lm6_solve(p0, g, iterations=5, cg_iters=25, huber_delta=1.0)
    torch.cuda.synchronize()
    out["lm_plain_err"], out["lm_k4_err"] = pose_max(a, b), pose_max(a, k4[0])
    _check("garage dist_fused6 LM 5 steps, kernel path vs plain path, max |d|",
           out["lm_plain_err"], TOL_SE3_LM_POSES)
    _check("garage dist_fused6 LM 5 steps, kernel path vs K4-LM, max |d|", out["lm_k4_err"],
           TOL_SE3_LM_POSES)
    if not int(sa[2]) == int(sb[2]) == int(k4[3]):
        fail(f"accepted steps differ: kernel path {int(sa[2])}, plain path {int(sb[2])}, "
             f"K4-LM {int(k4[3])}")
    out["lm_counts"] = counts
    return out


def phase_two_ranks6(torch, datasets, from_dataset, mesh):
    log("== phase 21: two gloo ranks on the one card (CUDA tensors), SE(3) kernel path, garage")
    from graphslam_tpu_torch.parallel import dist_fused6_gn_solve, dist_fused6_lm_solve

    (g, p0), (cfg, lm_cfg) = _two_rank_problem6(torch, datasets, from_dataset, mesh.device)
    one_gn = dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    one_lm, one_st = dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=True)
    torch.cuda.synchronize()
    res, secs = _spawn_two_ranks(torch, se3=True)
    el, tile = int(res["el"]), cfg.edge_tile
    first = math.ceil(math.ceil(el / tile) / 2) * tile  # rank 1's first loop edge
    log(f"  two ranks ran in {secs:.1f} s; loop edges {el} in tiles of {tile} (rank 1 from edge "
        f"{first}); rank 0 launched K7a {int(res['sizes'][0])} times")
    if not first < el:
        fail("rank 1 holds no loop edge")
    # relative to the largest coordinate: only the order in which the ranks'
    # loop partials are summed differs
    scale = float(one_gn[:, 9:].abs().max())
    e_gn = pose_max(res["gn"].to(p0.device), one_gn) / scale
    e_lm = pose_max(res["lm"].to(p0.device), one_lm) / scale
    _check("two ranks vs one rank, 3 GN iterations, max |d| over the largest coordinate", e_gn,
           TOL_MESH)
    _check("two ranks vs one rank, 3 LM steps, max |d| over the largest coordinate", e_lm,
           TOL_MESH)
    if int(res["stats"][2]) != int(one_st[2]):
        fail(f"two ranks accepted {int(res['stats'][2])} LM steps, one rank {int(one_st[2])}")
    return max(e_gn, e_lm)


def stage_a6_cost(N: int, c: int, El: int):
    """K7a: poses, chain and loop inputs and the CSR read once, the payload
    and the Aij stash written once; ~3500 operations to linearize an edge
    (as gn6_cost counts them), ~160 to assemble a node's chain blocks and
    weight them, and 84 per loop-edge term it sums."""
    nbytes = 4 * (12 * N + 48 * c + 48 * El + 2 * El + (N + 1) + 2 * El + 78 * N + 36 * El)
    return nbytes, 3500 * (c + El) + 160 * N + 84 * El


def gn_setup6_cost(N: int, K: int):
    """K7b: payload, poses, priors and lam read once; D, the K-level PCR
    factor, Dinv and b written once; ~1500 operations for a node's prior
    and damping, ~2400 per node and PCR level (two 6x6 inverses, four 6x6
    products)."""
    nbytes = 4 * (78 * N + 12 * N + 48 * N + 1 + 36 * N + 72 * K * N + 36 * N + 6 * N)
    return nbytes, 1500 * N + 2400 * K * N


def cg_step6_cost(N: int, El: int, K: int):
    """K7c, one pass: the carry, D, U, the PCR factor, Aij with its
    endpoints and the CSR read once; the carry written once; the update (30
    a node), the K-level PCR apply (156 a node and level) and Dinv (72),
    the direction and the dots (36), the chain H@p (228) and the loop H@p
    (156 an edge)."""
    nbytes = 4 * (2 * (24 * N + 4 + 6 * N + 1) + 36 * N + 36 * N + 72 * K * N + 36 * N
                  + 36 * El + 2 * El + (N + 1) + 2 * El)
    return nbytes, N * (30 + 156 * K + 72 + 36 + 228) + 156 * El


def phase_dist6_timing(torch, card, graphs, mesh):
    log("== phase 22: distributed SE(3) timing (sphere2500, world size 1 over NCCL)")
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.parallel import cg_step6 as cs6, dist_fused6, dist_fused6_gn_solve
    from graphslam_tpu_torch.solver import lm

    g, p0, _ = graphs["sphere2500"]
    cfg = SolverConfig(mode="gn_fused", cg_max_iterations=25, edge_tile=256, hvp_splits=1)
    iters, out = 20, {}

    def k7(p):
        return dist_fused6_gn_solve(p, g, mesh, cfg, iterations=iters)

    def k4(p):
        return lm._gn_loop(p, g, cfg, "gn_fused", iters)

    plain_iters = 2  # the plain path: a tenth of the solve

    def plain(p):
        return dist_fused6_gn_solve(p, g, mesh, cfg, iterations=plain_iters, cg_kernel=False)

    # in turns: plain, K4, K7, K7, K4, plain (the host's speed varies)
    t_pa = _time_solves(torch, plain, p0, 1, 1)
    t_4a = _time_solves(torch, k4, p0, 3, 2)
    t_7a = _time_solves(torch, k7, p0, 3, 2)
    t_7b = _time_solves(torch, k7, p0, 3, 2)
    t_4b = _time_solves(torch, k4, p0, 3, 2)
    t_pb = _time_solves(torch, plain, p0, 1, 1)
    out["k7_ms"] = 1e3 * min(t_7a, t_7b) / 2
    out["k4_ms"] = 1e3 * min(t_4a, t_4b) / 2
    out["plain_ms"] = 1e3 * min(t_pa, t_pb) * iters / plain_iters
    log(f"  card: {card}")
    log(f"  sphere2500 dist_fused6 GN through K7 ({iters} iterations, cg 25, exact PCR): "
        f"{out['k7_ms']:.3f} ms per solve ({1e3 * t_7a / 2:.3f} and {1e3 * t_7b / 2:.3f} in "
        f"turns), {iters * 1e3 / out['k7_ms']:.1f} GN it/s")
    log(f"  K4 (_gn_loop gn_fused, same config): {out['k4_ms']:.3f} ms per solve "
        f"({1e3 * t_4a / 2:.3f} and {1e3 * t_4b / 2:.3f}), {iters * 1e3 / out['k4_ms']:.1f} GN "
        f"it/s; the SE(3) 1-device gap K7/K4 = {out['k7_ms'] / out['k4_ms']:.2f}x")
    log(f"  plain path on the card: {1e3 * t_pa:.3f} ms before, {1e3 * t_pb:.3f} after per "
        f"{plain_iters}-iteration solve, {iters * 1e3 / out['plain_ms']:.1f} GN it/s")

    sh = dist_fused6._prepare6(p0, g, mesh, -1.0, cfg.pcr_levels, cfg.edge_tile)
    kern = sh.kernel()
    lam = torch.zeros(1, device=p0.device)
    payload, Aij = kern.stage_a(p0)
    st = kern.gn_setup(payload, p0, lam)
    carry = kern.cg_state(st.b)
    from graphslam_tpu_torch.ops import gn6_kernel as g6

    _k7a_bitwise(torch, cs6, g6, "sphere2500", g, p0)
    out["stage_a_us"] = _event_us(torch, lambda: cs6.stage_a6(sh, p0), 200)
    out["gn_setup_us"] = _event_us(torch, lambda: cs6.gn_setup6(sh, payload, p0, lam), 100)
    out["cg_step_us"] = _event_us(torch, lambda: cs6.cg_step6(sh, st, Aij, carry), 500)
    # K7a's, K7b's and K7c's C entries in turns with the staged sequences
    # they replaced: staged, one launch, one launch, staged (CUDA events)
    import ctypes

    kern.prob.stream = torch.cuda.current_stream(p0.device).cuda_stream
    lib, prob, step_args = kern.lib, ctypes.byref(kern.prob), kern._step_args[1:]
    entries = {
        "stage_a": (lambda: lib.cg6_stage_a(prob), lambda: lib.cg6_stage_a_staged(prob), 200),
        "gn_setup": (lambda: lib.cg6_gn_setup(prob, lam.data_ptr()),
                     lambda: lib.cg6_gn_setup_staged(prob, lam.data_ptr()), 100),
        "cg_step": (lambda: lib.cg6_step(prob, *step_args),
                    lambda: lib.cg6_step_staged(prob, *step_args), 500),
    }
    lib.cg6_row_ctas.argtypes = [ctypes.c_longlong]
    for key, (new, old, reps) in entries.items():
        for fn in (new, old):
            rc = fn()
            if rc:
                fail(f"cg6_{key}: a C entry returned CUDA error {rc}")
        t_sa = _event_us(torch, old, reps)
        t_na = _event_us(torch, new, reps)
        t_nb = _event_us(torch, new, reps)
        t_sb = _event_us(torch, old, reps)
        host, dev_n = _launches_per_call(torch, new, "Cg6Problem")
        host_s, dev_s = _launches_per_call(torch, old, "Cg6Problem")
        kname = {"stage_a": "cg6_stage_a_persistent", "gn_setup": "cg6_gn_setup_wide",
                 "cg_step": "cg6_step_wide"}[key]
        regs, spill = _ptxas("cg_step6", kname)
        ctas = (lib.cg6_row_ctas(max(sh.N, sh.c + sh.El)) if key == "stage_a"
                else lib.cg6_wide_ctas(sh.N))  # < 0: a cooperative grid
        out[f"{key}_entry"] = dict(us=min(t_na, t_nb), us_staged=min(t_sa, t_sb), launches=host,
                                   staged_launches=host_s, ptxas={kname: (regs, spill)},
                                   ctas=ctas)
        tag = {"stage_a": "K7a", "gn_setup": "K7b", "cg_step": "K7c"}[key]
        log(f"  {tag} at sphere2500 ({abs(ctas)} CTAs, "
            f"{'a cooperative grid' if ctas < 0 else 'a cluster'}), C entries in turns (CUDA "
            f"events): cg6_{key.replace('cg_', '')} "
            f"(one launch) {t_na:.2f} and {t_nb:.2f} us, staged {t_sa:.2f} and {t_sb:.2f} us "
            f"({min(t_sa, t_sb) / min(t_na, t_nb):.2f}x); launches a call (profiler, 10 calls; "
            f"host launch calls / device kernels): {host:g} / {dev_n:g}, staged {host_s:g} / "
            f"{dev_s:g}; ptxas {kname} {regs} registers, {spill} bytes spill stores")
        if host != 1:
            fail(f"{tag} made {host} launch calls a call, not 1")
    out["stage_a_plain_us"] = _event_us(torch, lambda: cs6.stage_a6_reference(sh, p0), 10)
    ref_pay, ref_A = cs6.stage_a6_reference(sh, p0)
    out["gn_setup_plain_us"] = _event_us(
        torch, lambda: cs6.gn_setup6_reference(sh, ref_pay, p0, lam), 5, warmup=1)
    ref_st = cs6.gn_setup6_reference(sh, ref_pay, p0, lam)
    ref_carry = cs6.cg_state(ref_st.b)
    out["cg_step_plain_us"] = _event_us(
        torch, lambda: cs6.cg_step6_reference(sh, ref_st, ref_A, ref_carry), 20)
    big = torch.zeros(6 * sh.N + 1, device=p0.device)
    pay = torch.zeros(cs6.payload_size6(sh.N), device=p0.device)
    out["allreduce_big_us"] = _event_us(torch, lambda: mesh.all_reduce(big), 500)
    out["allreduce_payload_us"] = _event_us(torch, lambda: mesh.all_reduce(pay), 200)
    out["k7_launch_counts_per_call"] = tuple(out[f"{k}_entry"]["launches"]
                                             for k in ("stage_a", "gn_setup", "cg_step"))
    log(f"  per call at sphere2500 (K = {sh.K}; CUDA events, the wrapper included): K7a "
        f"{out['stage_a_us']:.2f} us, K7b {out['gn_setup_us']:.2f} us, K7c "
        f"{out['cg_step_us']:.2f} us; twins on the card {out['stage_a_plain_us']:.2f}, "
        f"{out['gn_setup_plain_us']:.2f}, {out['cg_step_plain_us']:.2f} us")
    log(f"  all_reduce at world size 1 (NCCL): {out['allreduce_big_us']:.2f} us for the "
        f"[tile_Ap; s1] buffer ({6 * sh.N + 1} floats), {out['allreduce_payload_us']:.2f} us for "
        f"the payload ({cs6.payload_size6(sh.N)} floats)")

    n_it = 5
    k7 = (cs6.stage_a6, cs6.gn_setup6, cs6.cg_step6)
    _launch_counts(k7, zero=True)
    groups, span = _profile_launches(torch, lambda: dist_fused6_gn_solve(
        p0, g, mesh, cfg, iterations=n_it), top=10)
    calls = _launch_counts(k7)
    out["launches_per_it"] = {k: c / n_it for k, (c, _) in groups.items()}
    out["idle_share"] = _log_profile(f"sphere2500 dist_fused6 GN through K7 ({n_it} iterations)",
                                     groups, span, n_it)
    per_call = out["k7_launch_counts_per_call"]
    per_it = sum(calls[f.__name__] * n for f, n in zip(k7, per_call)) / n_it
    out["cg_step6_launches_per_it"] = per_it
    dev_it = out["launches_per_it"]["cg_step6.cu"]
    log(f"  cg_step6.cu launches a dist_fused6 GN iteration: {per_it:g} (wrapper calls {calls} "
        f"over {n_it} iterations times host launch calls a call {per_call}; K7a 1, K7b 1, 26 K7c "
        f"passes 1 each: 28; staged: 2 + {1 + sh.K} + 26 x {4 + sh.K} = "
        f"{2 + 1 + sh.K + 26 * (4 + sh.K)}); device kernels the profiler kept: {dev_it:.1f}")
    if per_it != 1 + 1 + 26:
        fail(f"{per_it} cg_step6.cu launches a dist_fused6 GN iteration, not 28")
    return out, sh


def make_tour(torch):
    """The replay's scans, made on the card with the port's raycaster."""
    from graphslam_tpu_torch.config import SLAMConfig, SolverConfig
    from graphslam_tpu_torch.frontend.projection import beam_angles, scan_to_points
    from graphslam_tpu_torch.sim import simulate_trajectory
    import numpy as np

    cfg = SLAMConfig(max_keyframes=1024, max_factors=1024, solve_iterations=4,
                     solver=SolverConfig(mode="gn_fused", cg_max_iterations=12))
    fc = cfg.frontend
    sim = simulate_trajectory(fc, step_len=0.25, seed=1)
    n = min(300, len(sim["scans"]))
    odom = np.concatenate([np.zeros((1, 3), np.float32), sim["odom_deltas"][: n - 1]])
    dev = torch.device("cuda")
    scans = torch.from_numpy(sim["scans"][:n]).to(dev)
    angles = beam_angles(fc.num_beams, fc.fov_rad, device=dev)
    pts, masks = zip(*(scan_to_points(r, angles, fc.min_range, fc.max_range, fc.max_points)
                       for r in scans))
    return dict(cfg=cfg, n=n, scans=scans, odom=torch.from_numpy(odom).to(dev), odom_np=odom,
                gt=sim["gt_poses"][:n], pts=torch.stack(pts), masks=torch.stack(masks))


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
    p0, g, m3500_launches, err = phase_main(torch, datasets, from_dataset, chi2, metrics, lm,
                                            cfg, gk)
    ms_k, ms_p, k1 = phase_timing(torch, gk, cfg, card, p0, g)

    tour = make_tour(torch)
    tour["card"] = card
    fe, k2_full = phase_frontend_kernels(torch, tour)
    launches, gn_replay_err, replay_state = phase_replay(torch, metrics, tour)
    t = phase_timing_frontend(torch, tour, k2_full)
    lm_err9, k3_err9 = phase_lm_kernels(torch, datasets, from_dataset, lm, gk, tour, replay_state)
    p_m, g_m, sys_m, lm_main, lm_err10, k3_err10 = phase_lm_main(
        torch, datasets, from_dataset, chi2, metrics, lm, gk)
    lt = phase_lm_timing(torch, lm, gk, card, p_m, g_m, sys_m, lm_main)
    se3_err = phase_se3_kernels(torch, datasets, from_dataset, lm)
    se3_graphs = _se3_main(torch, datasets, from_dataset)
    se3_main = phase_se3_main(torch, se3_graphs, chi2, metrics, lm)
    st = phase_se3_timing(torch, card, se3_graphs, lm)
    k6_err = phase_k6_kernels(torch, datasets, from_dataset)
    dm = phase_dist_main(torch, datasets, from_dataset, chi2, metrics)
    two_rank_err = phase_two_ranks(torch, datasets, from_dataset, dm["mesh"])
    dt = phase_dist_timing(torch, card, dm)
    k7_err = phase_k7_kernels(torch, _se3_graphs(torch, datasets, from_dataset))
    d6 = phase_dist6_main(torch, se3_graphs, chi2, metrics, dm["mesh"])
    two_rank6_err = phase_two_ranks6(torch, datasets, from_dataset, dm["mesh"])
    t6, sh6 = phase_dist6_timing(torch, card, se3_graphs, dm["mesh"])
    if "jax" in sys.modules:
        fail("the port imported jax")

    from graphslam_tpu_torch.ops.gn_kernel import pack_graph

    pk = pack_graph(g, p0.shape[0])
    gn_bound, gn_by = _bound(*gn_cost(pk.N, pk.c, pk.El, 4, 50, cfg.cg_max_iterations))
    cg_bytes = gn_cg_stream_bytes(pk.N, pk.El, 4)
    log(f"  K1 bound per m3500 solve {gn_bound:.4f} ms ({gn_by}); one CG iteration's working "
        f"set {cg_bytes} bytes = {1e6 * cg_bytes / HBM_BYTES_PER_S:.3f} us at "
        f"{HBM_BYTES_PER_S / 1e12} TB/s, {50 * 26 * 1e3 * cg_bytes / HBM_BYTES_PER_S:.3f} ms "
        f"per solve (50 x 26 CG passes)")
    P, Q = k2_full[0].shape[0], k2_full[3].shape[0]
    k2_bound, k2_by = _bound(*icp_iteration_cost(P, Q))
    k8_bound, k8_by = _bound(*nn_cost(P, Q))
    lm_bound, lm_by = _bound(*lm_cost(pk.N, pk.c, pk.El, 4, 50, 25))
    K3 = math.ceil(math.log2(pk.N))
    k3_bound, k3_by = _bound(*pcg_cost(pk.N, pk.El, K3, 25))
    log(f"  K1-LM bound per m3500 solve {lm_bound:.4f} ms ({lm_by}); K3 bound per call at m3500 "
        f"{k3_bound * 1e3:.3f} us ({k3_by}, K = {K3})")
    from graphslam_tpu_torch.ops.gn6_kernel import pack_graph6

    Ns, Ng = (int(se3_graphs[k][1].shape[0]) for k in ("sphere2500", "garage"))
    ps, pg = pack_graph6(se3_graphs["sphere2500"][0], Ns), pack_graph6(se3_graphs["garage"][0], Ng)
    Ks, Kg = math.ceil(math.log2(Ns)), math.ceil(math.log2(Ng))
    gn6_bound, gn6_by = _bound(*gn6_cost(Ns, ps.c, ps.El, Ks, 20, 25))
    lm6_bound, lm6_by = _bound(*lm6_cost(Ng, pg.c, pg.El, Kg, 20, 25))
    k5_bound, k5_by = _bound(*pcg6_cost(Ng, pg.El, Kg, 25))
    log(f"  K4 bound per sphere2500 20-iteration solve {gn6_bound:.4f} ms ({gn6_by}, K = {Ks}); "
        f"K4-LM per garage 20-step solve {lm6_bound:.4f} ms ({lm6_by}); K5 per call at garage "
        f"{k5_bound * 1e3:.3f} us ({k5_by}, K = {Kg})")
    from graphslam_tpu_torch.parallel import dist_fused

    sh = dist_fused._prepare(p0, g, dm["mesh"], -1.0, 4, 512)
    k6a_bound, k6a_by = _bound(*stage_a_cost(sh.N, sh.c, sh.El))
    k6b_bound, k6b_by = _bound(*gn_setup_cost(sh.N, sh.K))
    k6c_bound, k6c_by = _bound(*cg_step_cost(sh.N, sh.El, sh.K))
    log(f"  K6 bounds per call at m3500 (K = {sh.K}): K6a {k6a_bound * 1e3:.3f} us ({k6a_by}), "
        f"K6b {k6b_bound * 1e3:.3f} us ({k6b_by}), K6c {k6c_bound * 1e3:.3f} us ({k6c_by})")
    k7a_bound, k7a_by = _bound(*stage_a6_cost(sh6.N, sh6.c, sh6.El))
    k7b_bound, k7b_by = _bound(*gn_setup6_cost(sh6.N, sh6.K))
    k7c_bound, k7c_by = _bound(*cg_step6_cost(sh6.N, sh6.El, sh6.K))
    log(f"  K7 bounds per call at sphere2500 (K = {sh6.K}): K7a {k7a_bound * 1e3:.3f} us "
        f"({k7a_by}), K7b {k7b_bound * 1e3:.3f} us ({k7b_by}), K7c {k7c_bound * 1e3:.3f} us "
        f"({k7c_by})")
    log("== end to end, the figures of phases 5, 8, 11 and 14 again")
    log(f"  m3500 GN {50e3 / ms_k:.1f} it/s, m3500 LM {50e3 / lt['lm_ms']:.1f} it/s (K1, "
        f"K1-LM: one launch a solve); replay {t['fps']:.2f} frames/s; sphere2500 GN "
        f"{20e3 / st['sphere2500_ms']:.1f} it/s, garage GN {20e3 / st['garage_ms']:.1f} it/s, "
        f"garage LM {20e3 / st['lm_ms']:.1f} it/s (K4, K4-LM: one launch a solve); {card}")

    def redesign(red, idle):
        """The kernels line's fields of a row redesigned as one launch a solve."""
        return {"redesigned": True, "ms_entry": red["ms"], "ms_staged": red["ms_staged"],
                "launches_per_solve": red["launches"],
                "staged_launches_per_solve": red["staged_launches"], "idle_share": idle,
                "registers": {k: v[0] for k, v in red["ptxas"].items()},
                "spill_store_bytes": {k: v[1] for k, v in red["ptxas"].items()}}

    def k7_redesign(red):
        """The kernels line's fields of K7a, K7b or K7c, one launch a call."""
        return {"redesigned": True, "ms_entry": red["us"] / 1e3, "ms_staged": red["us_staged"] / 1e3,
                "launches_per_call": red["launches"],
                "staged_launches_per_call": red["staged_launches"],
                "launches_per_it_cg_step6": t6["cg_step6_launches_per_it"],
                "ctas": abs(red["ctas"]), "cooperative_grid": red["ctas"] < 0,
                "registers": {k: v[0] for k, v in red["ptxas"].items()},
                "spill_store_bytes": {k: v[1] for k, v in red["ptxas"].items()}}

    def k6_redesign(red):
        """The kernels line's fields of K6a or K6b, one launch a call."""
        return {"redesigned": True, "ms_entry": red["us"] / 1e3, "ms_staged": red["us_staged"] / 1e3,
                "ms_wrapper_staged": red["us_wrapper_staged"] / 1e3,
                "launches_per_call": red["launches"],
                "staged_launches_per_call": red["staged_launches"],
                "launches_per_it_cg_step": dt["cg_step_launches_per_it"],
                "ctas": abs(red["ctas"]), "cooperative_grid": red["ctas"] < 0,
                "registers": {k: v[0] for k, v in red["ptxas"].items()},
                "spill_store_bytes": {k: v[1] for k, v in red["ptxas"].items()}}

    k6_common = dict(route="cuda", source="graphslam_tpu_torch/csrc/cg_step.cu", library_ms=None)
    k7_common = dict(route="cuda", source="graphslam_tpu_torch/csrc/cg_step6.cu", library_ms=None)
    print(json.dumps({"kernels": [
        {
            "name": "gn_kernel",
            "route": "cuda",
            "source": "graphslam_tpu_torch/csrc/gn_kernel.cu",
            "replaces": "graphslam_tpu/ops/gn_kernel.py:600",
            "launches": launches["gn_kernel"],
            "launches_m3500": m3500_launches,
            "max_abs_err": max(err, gn_replay_err),
            "max_abs_err_m3500": err,
            "max_abs_err_replay_solve": gn_replay_err,
            "ms": ms_k,
            "plain_ms": ms_p,
            "bound_ms": gn_bound,
            "bound_by": gn_by,
            "library_ms": None,
            **redesign(k1, k1["idle_share"]),
        },
        {
            "name": "icp_kernel",
            "route": "cuda",
            "redesigned": True,
            "source": "graphslam_tpu_torch/csrc/icp_kernel.cu",
            "replaces": "graphslam_tpu/ops/icp_kernel.py:30",
            "launches": launches["icp_kernel"],
            "rounds_run": t["k2_rounds_run"],
            "rounds_enqueued_staged": t["k2_rounds_enqueued"],
            "max_abs_err": fe["match_err"],
            "iteration_err_over_limit": fe["k2_ratio"],
            "ms": t["k2_us"] / 1e3,
            "ms_staged": t["k2_staged_us"] / 1e3,
            "ms_match_entry": t["k2_match_entry_us"] / 1e3,
            "ms_match_entry_staged": t["k2_match_entry_staged_us"] / 1e3,
            "ms_gicp_match": t["match_us"] / 1e3,
            "ms_gicp_match_staged": t["match_staged_us"] / 1e3,
            "launches_per_match": t["k2_launches_per_match"],
            "staged_launches_per_match": t["k2_staged_launches_per_match"],
            "replay_fps": t["fps"],
            "replay_fps_k2_staged": t["fps_k2_staged"],
            "registers": {k: v[0] for k, v in t["k2_ptxas"].items()},
            "spill_store_bytes": {k: v[1] for k, v in t["k2_ptxas"].items()},
            "plain_ms": t["k2_plain_us"] / 1e3,
            "bound_ms": k2_bound,
            "bound_by": k2_by,
            "library_ms": None,
        },
        {
            "name": "nn_kernel",
            "route": "cuda",
            "source": "graphslam_tpu_torch/csrc/icp_kernel.cu",
            "replaces": "graphslam_tpu/ops/correspondence.py:39",
            "redesigned": True,
            "launches": launches["nn_kernel"],
            "max_abs_err": fe["k8_err"],
            "ms": t["k8_us"] / 1e3,
            "ms_staged": t["k8_serial_us"] / 1e3,
            "ms_launch": t["k8_launch_us"] / 1e3,
            "ms_launch_staged": t["k8_serial_launch_us"] / 1e3,
            "launches_per_call": t["k8_launches_per_call"],
            "staged_launches_per_call": t["k8_serial_launches_per_call"],
            "group_threads": t["k8_shape"][0],
            "cta_threads": t["k8_shape"][1],
            "registers": {k: v[0] for k, v in t["k8_ptxas"].items()},
            "spill_store_bytes": {k: v[1] for k, v in t["k8_ptxas"].items()},
            "plain_ms": t["k8_plain_us"] / 1e3,
            "bound_ms": k8_bound,
            "bound_by": k8_by,
            "library_ms": t["k8_cdist_us"] / 1e3,
        },
        {
            "name": "gn_kernel_lm",
            "route": "cuda",
            "source": "graphslam_tpu_torch/csrc/gn_kernel.cu",
            "replaces": "graphslam_tpu/ops/gn_kernel.py:600",
            "launches": lm_main["K1-LM"]["launches"],
            "max_abs_err": max(lm_err9, lm_err10),
            "ms": lt["lm_ms"],
            "plain_ms": lt["lm_plain_ms"],
            "bound_ms": lm_bound,
            "bound_by": lm_by,
            "library_ms": None,
            **redesign(lt["redesigned"], lt["lm_idle_share"]),
        },
        {
            "name": "pcg_kernel",
            "route": "cuda",
            "redesigned": True,
            "source": "graphslam_tpu_torch/csrc/gn_kernel.cu",
            "replaces": "graphslam_tpu/ops/pcg_kernel.py:283",
            "launches": lm_main["_lm_loop/K3"]["launches"],
            "max_abs_err": max(k3_err9, k3_err10),
            "ms": lt["k3_us"] / 1e3,
            "ms_staged": lt["k3_staged_us"] / 1e3,
            "launches_per_call": lt["k3_launches_per_call"],
            "staged_launches_per_call": lt["k3_staged_launches_per_call"],
            "ms_wrapper": lt["k3_wrapper_us"] / 1e3,
            "plain_ms": lt["k3_plain_us"] / 1e3,
            "bound_ms": k3_bound,
            "bound_by": k3_by,
            "library_ms": None,
        },
        {
            "name": "gn6_kernel",
            "route": "cuda",
            "source": "graphslam_tpu_torch/csrc/gn6_kernel.cu",
            "replaces": "graphslam_tpu/ops/gn6_kernel.py:602",
            "launches": se3_main["sphere2500"]["launches"],
            "launches_garage": se3_main["garage"]["launches"],
            "max_abs_err": max(se3_err["gn"], se3_main["sphere2500_err"]),
            "ms": st["sphere2500_ms"],
            "plain_ms": st["sphere2500_plain_ms"],
            "ms_garage": st["garage_ms"],
            "plain_ms_garage": st["garage_plain_ms"],
            "bound_ms": gn6_bound,
            "bound_by": gn6_by,
            "library_ms": None,
            **redesign(st["sphere2500_redesigned"], st["gn_idle_share"]),
            "ms_entry_garage": st["garage_redesigned"]["ms"],
            "ms_staged_garage": st["garage_redesigned"]["ms_staged"],
        },
        {
            "name": "gn6_kernel_lm",
            "route": "cuda",
            "source": "graphslam_tpu_torch/csrc/gn6_kernel.cu",
            "replaces": "graphslam_tpu/ops/gn6_kernel.py:602",
            "launches": se3_main["garage_lm_gn_fused"]["launches"],
            "max_abs_err": se3_err["lm"],
            "ms": st["lm_ms"],
            "plain_ms": st["lm_plain_ms"],
            "bound_ms": lm6_bound,
            "bound_by": lm6_by,
            "library_ms": None,
            **redesign(st["lm_redesigned"], st["lm_idle_share"]),
        },
        {
            "name": "pcg6_kernel",
            "route": "cuda",
            "redesigned": True,
            "source": "graphslam_tpu_torch/csrc/gn6_kernel.cu",
            "replaces": "graphslam_tpu/ops/pcg6_kernel.py:207",
            "launches": se3_main["garage_lm_pcg_fused"]["launches"],
            "max_abs_err": se3_err["k5"],
            "ms": st["k5_us"] / 1e3,
            "ms_staged": st["k5_staged_us"] / 1e3,
            "launches_per_call": st["k5_launches_per_call"],
            "staged_launches_per_call": st["k5_staged_launches_per_call"],
            "registers": {k: v[0] for k, v in st["k5_ptxas"].items()},
            "spill_store_bytes": {k: v[1] for k, v in st["k5_ptxas"].items()},
            "ms_wrapper": st["k5_wrapper_us"] / 1e3,
            "ms_wrapper_staged": st["k5_wrapper_staged_us"] / 1e3,
            "plain_ms": st["k5_plain_us"] / 1e3,
            "bound_ms": k5_bound,
            "bound_by": k5_by,
            "library_ms": None,
        },
        {
            "name": "cg_step_stage_a",
            **k6_common,
            "replaces": "graphslam_tpu/parallel/cg_step.py:200",
            "launches": dm["gn_counts"]["stage_a"],
            "launches_lm": dm["lm_counts"]["stage_a"],
            "max_abs_err": k6_err["stage_a"],
            "ms": dt["stage_a_us"] / 1e3,
            **k6_redesign(dt["stage_a_entry"]),
            "plain_ms": dt["stage_a_plain_us"] / 1e3,
            "bound_ms": k6a_bound,
            "bound_by": k6a_by,
        },
        {
            "name": "cg_step_gn_setup",
            **k6_common,
            "replaces": "graphslam_tpu/parallel/cg_step.py:323",
            "launches": dm["gn_counts"]["gn_setup"],
            "launches_lm": dm["lm_counts"]["gn_setup"],
            "max_abs_err": k6_err["gn_setup"],
            "ms": dt["gn_setup_us"] / 1e3,
            **k6_redesign(dt["gn_setup_entry"]),
            "plain_ms": dt["gn_setup_plain_us"] / 1e3,
            "bound_ms": k6b_bound,
            "bound_by": k6b_by,
        },
        {
            "name": "cg_step_cg_step",
            "redesigned": True,
            **k6_common,
            "replaces": "graphslam_tpu/parallel/cg_step.py:90",
            "launches": dm["gn_counts"]["cg_step"],
            "launches_lm": dm["lm_counts"]["cg_step"],
            "max_abs_err": max(k6_err["cg_step_26"], two_rank_err),
            "max_abs_err_1_pass": k6_err["cg_step_1"],
            "max_abs_err_two_ranks": two_rank_err,
            "ms": dt["cg_step_us"] / 1e3,
            "ms_staged": dt["cg_step_staged_us"] / 1e3,
            "launches_per_pass": dt["cg_step_launches_per_pass"],
            "staged_launches_per_pass": dt["cg_step_staged_launches_per_pass"],
            "plain_ms": dt["cg_step_plain_us"] / 1e3,
            "bound_ms": k6c_bound,
            "bound_by": k6c_by,
            "dist_fused_gn_ms_per_solve": dt["k6_ms"],
        },
        {
            "name": "cg_step6_stage_a",
            **k7_common,
            "replaces": "graphslam_tpu/parallel/cg_step6.py:111",
            "launches": d6["sphere2500_counts"]["stage_a6"],
            "launches_garage": d6["garage_counts"]["stage_a6"],
            "launches_lm": d6["lm_counts"]["stage_a6"],
            "max_abs_err": k7_err["stage_a"],
            "ms": t6["stage_a_us"] / 1e3,
            **k7_redesign(t6["stage_a_entry"]),
            "plain_ms": t6["stage_a_plain_us"] / 1e3,
            "bound_ms": k7a_bound,
            "bound_by": k7a_by,
        },
        {
            "name": "cg_step6_gn_setup",
            **k7_common,
            "replaces": "graphslam_tpu/parallel/cg_step6.py:240",
            "launches": d6["sphere2500_counts"]["gn_setup6"],
            "launches_garage": d6["garage_counts"]["gn_setup6"],
            "launches_lm": d6["lm_counts"]["gn_setup6"],
            "max_abs_err": k7_err["gn_setup"],
            "ms": t6["gn_setup_us"] / 1e3,
            **k7_redesign(t6["gn_setup_entry"]),
            "plain_ms": t6["gn_setup_plain_us"] / 1e3,
            "bound_ms": k7b_bound,
            "bound_by": k7b_by,
        },
        {
            "name": "cg_step6_cg_step",
            **k7_common,
            "replaces": "graphslam_tpu/parallel/cg_step6.py:341",
            "launches": d6["sphere2500_counts"]["cg_step6"],
            "launches_garage": d6["garage_counts"]["cg_step6"],
            "launches_lm": d6["lm_counts"]["cg_step6"],
            "max_abs_err": max(k7_err["cg_step_26"], two_rank6_err),
            "max_abs_err_1_pass": k7_err["cg_step_1"],
            "max_abs_err_two_ranks": two_rank6_err,
            "ms": t6["cg_step_us"] / 1e3,
            **k7_redesign(t6["cg_step_entry"]),
            "plain_ms": t6["cg_step_plain_us"] / 1e3,
            "bound_ms": k7c_bound,
            "bound_by": k7c_by,
            "dist_fused6_gn_ms_per_solve": t6["k7_ms"],
        },
    ]}), flush=True)
    import torch.distributed as tdist

    if tdist.is_initialized():
        tdist.destroy_process_group()
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu",
        "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
