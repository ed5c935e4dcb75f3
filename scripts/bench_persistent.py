#!/usr/bin/env python3
"""End-to-end paths and the persistent kernels' launch shapes, one tree to
a process, in turns on one NVIDIA GPU: what chip_smoke.py cannot compare
inside one process.

Usage, from the root of a checkout:

  python3 scripts/bench_persistent.py [--parent DIR] [--rounds R]
                                      [--parts replay,dist,k4,k2,k5,k6,k7,k7a,k8]

Trees:
  this         this checkout's graphslam_tpu_torch
  parent       with --parent, the package of another checkout (for example
               the parent commit unpacked with `git archive` into a
               directory that .gitignore lists)
  other-shape  a copy of this checkout's package (under
               graphslam_tpu_torch/build/, rebuilt there) whose
               csrc/persistent.cuh::pass_shape takes the other launch
               shape (for K4, K6a/K6b and K7b/K7c alike): sphere2500 on one
               16-CTA cluster walking 3 passes over the rows instead of a
               42-CTA cooperative grid, garage on a 16-CTA cooperative grid
               instead of a 16-CTA cluster, K6a and K6b at m3500 on a
               16-CTA cluster walking passes instead of an 85- and a
               55-CTA grid
  k6-threads32, k6-threads128, k6-threads256, k6-threads512,
  k6-threads1024, k6-inline, k6-gridconst
               copies likewise whose csrc/cg_step.cu runs K6a and K6b on
               CTAs of 32 to 1024 threads instead of 64 (kRowThreads),
               inlines their row functions (__forceinline__ in place of
               __noinline__), or passes their kernels' parameters as
               __grid_constant__ (the row functions then read them in
               place, not from a per-thread copy)
  k7a-threads64, k7a-threads128, k7a-groups6, k7a-noinline-linearize,
  k7a-inline-assemble, k7a-swapped-inline
               copies likewise whose csrc/cg_step6.cu runs K7a on CTAs of
               64 or 128 threads instead of 32 (kRowThreads6), or gives
               each edge of its linearize stage a group of 6 threads (5
               groups a warp, every thread of the group running the serial
               linearize_edge, thread a then row a of the three 6x6
               products and component a of the two 6-vectors, sum for sum
               in m6Tmul's and m6Tvec's order) on 64-thread CTAs, or
               compiles K7a's linearize row once as a __noinline__ body
               that the staged and the persistent kernels call (in place
               of inlining it; both rows then __noinline__), or inlines its
               assemble row too (__forceinline__ in place of __noinline__;
               both rows inlined), or does both (linearize __noinline__,
               assemble inlined)
  k2-group16, k2-group32, k2-threads256, k2-threads512
               copies likewise whose csrc/icp_kernel.cu gives each source
               point a group of 16 or 32 threads instead of 8 (kGroup), or
               runs CTAs of 256 or 512 threads instead of 1024
               (kLoopThreads)
  k8-g4-t128, ..., k8-g32-t1024
               copies likewise whose csrc/icp_kernel.cu runs K8 with a
               group of 4, 8, 16 or 32 threads a source point (kNnGroup)
               on CTAs of 128, 256 or 1024 threads (kNnThreads): every
               pair but 16 x 256, this tree's

Each tree runs in a fresh process (`--child DIR`), in the order parent,
this, the copies (those --trees names, where given), then the reverse, R
times. A process builds its tree's
kernels (cached in the tree), warms up and prints one JSON line:
  replay  frames/s of the 278-scan closed-loop replay (chip_smoke.py's
          phase 8 configuration), median of 3, and a digest of the
          replay's keyframe poses, keyframe count and loop count (equal
          digests: bitwise equal replays); and ms per call of K1's C
          entry (GnKernel.solve: one launch in this tree, the staged
          sequence in a tree from before the persistent K1) at the
          replay's last solve
          (the final map in its 128-pose bucket, 4 warm iterations at cg
          12, exact PCR), CUDA events over 50 calls
  dist    m3500 dist_fused GN it/s (200 iterations, cg 25, pcr_levels 4)
          and sphere2500 dist_fused6 GN it/s (20 iterations, cg 25), world
          size 1 over NCCL (phases 18 and 22)
  k4      ms per fused_gn6_solve at sphere2500 and garage (20 iterations,
          cg 25, exact PCR) and per fused_lm6_solve at garage (20 Huber
          steps), median of 3 chains of 5; the CTAs of the wide launch
  k2      us per call of K2's C entries at full width on the replay's
          scans 1 and 0 (P = Q = 1152): one round (icp_iteration) over 500
          calls, one match (icp_match, 32 rounds, early exit) over 200,
          and us per gicp_match (surfel covariances included) over 50,
          CUDA events
  k5      us per fused_pcg6_solve at garage (exact PCR, cg 25, the LM
          loop's initial damping) over 50 calls, CUDA events, and garage
          LM it/s through lm_solve(mode="pcg_fused") (20 iterations, cg
          25, Huber 1.0), median of 3
  k6      us per call of K6a's and K6b's C entries at m3500 (one rank
          owning every loop edge, K = 4), CUDA events over 200 calls, and
          of their staged sequences where the tree has them
          (cg_stage_a_staged, cg_gn_setup_staged); the CTAs of their
          launches (negative: a cooperative grid); and a digest of two
          ranks' K6a, K6b and 26 K6c passes at m3500 with Huber, as k7's
          (equal digests across trees: bitwise equal K6)
  k7      us per call of K7b's and K7c's C entries at sphere2500 (one rank
          owning every loop edge, exact PCR, K = 12), CUDA events over 100
          and 500 calls, and of their staged sequences where the tree has
          them (cg6_gn_setup_staged, cg6_step_staged); the CTAs of the
          persistent launch; and a digest of two ranks' K7a, K7b and 26 K7c
          passes at sphere2500 with Huber (both ranks' outputs), through
          the tree's gn_setup / cg_step and, where it has them, through the
          staged sequences (equal digests across trees: bitwise equal K7)
  k7a     us per call of K7a's C entry at sphere2500 and at garage (one
          rank owning every loop edge), CUDA events over 200 calls, and of
          cg6_stage_a_staged where the tree has it; the CTAs of the launch
          (negative: a cooperative grid); a digest of two ranks' K7a
          outputs (payloads and Aij, half the loop edges each, with and
          without Huber) at both graphs, and one of the Aij stashes alone
          (the linearize stage's), through stage_a and, where the tree has
          it, stage_a_staged (equal digests: bitwise equal K7a)
  k8      us of K8's C entries at P = Q = 1152 (the replay's scans 1
          and 0, as k2): nn_search, and nn_search_serial where the tree
          has it, in turns (each in order, then in reverse), a launch by
          CUDA events around replays of a CUDA graph of 50 launches (the
          device's time, without the host's work between launches) and a
          call by CUDA events around 500 back-to-back calls (the host's
          ctypes work included); the tree's group and CTA widths; a digest
          of idx and d2 of each (equal digests: bitwise equal results)
K2's part also prints a digest of icp_match's and icp_iteration's outputs
(and of the staged entries' where the tree has them). The other-shape
tree runs k4, k6 and k7 only, the k2-* trees k2 only, the k6-* trees k6
only, the k7a-* trees k7a only, the k8-* trees k8 only. The card's
name and power limit come first; the last line is a JSON summary of every
process's numbers.
"""

import argparse
import hashlib
import json
import shutil
import statistics
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent

# The one line of wide_shape that picks the shape, and its other branch:
# the cluster where one pass over the rows takes more than 16 CTAs (capped
# at 16), the cooperative grid where it takes at most 16.
SHAPE_RULE = [("  if (want <= kMaxClusterCtas) {\n    sh = Shape{want, false};",
               "  if (want > kMaxClusterCtas) {\n    sh = Shape{kMaxClusterCtas, false};", 1)]
# K2's launch shape (csrc/icp_kernel.cu) and the copies that take another:
# {tree: (kept line, its replacement)}.
K2_SHAPES = {
    "k2-group16": [("constexpr int kGroup = 8;", "constexpr int kGroup = 16;", 1)],
    "k2-group32": [("constexpr int kGroup = 8;", "constexpr int kGroup = 32;", 1)],
    "k2-threads256": [("constexpr int kLoopThreads = 1024;", "constexpr int kLoopThreads = 256;",
                       1)],
    "k2-threads512": [("constexpr int kLoopThreads = 1024;", "constexpr int kLoopThreads = 512;",
                       1)],
}
# K6a's and K6b's CTA width, row functions and kernel parameters
# (csrc/cg_step.cu) and the copies that take others: {tree: [(kept text,
# its replacement, occurrences), ...]}.
K6_SHAPES = {
    **{f"k6-threads{t}": [("constexpr int kRowThreads = 64;",
                           f"constexpr int kRowThreads = {t};", 1)]
       for t in (32, 128, 256, 512, 1024)},
    "k6-inline": [("__device__ __noinline__ void", "__device__ __forceinline__ void", 3)],
    "k6-gridconst": [
        ("(CgProblem p, Ws w)", "(const __grid_constant__ CgProblem p, "
         "const __grid_constant__ Ws w)", 3),
        ("cg_setup(CgProblem p,", "cg_setup(const __grid_constant__ CgProblem p,", 1),
        ("cg_gn_setup_persistent(CgProblem p, Ws w,", "cg_gn_setup_persistent("
         "const __grid_constant__ CgProblem p, const __grid_constant__ Ws w,", 1)],
}
# K7a's CTA width and linearize stage (csrc/cg_step6.cu) and the copies
# that take others: {tree: [(kept text, its replacement, occurrences), ...]}.
K7A_GROUP_LANE = """// Edge e's linearization on thread a of its group of 6: the serial
// linearize_edge, then row a of Aij, Aii, Ajj and component a of gi, gj,
// sum for sum in m6Tmul's and m6Tvec's order.
__device__ __noinline__ void linearize_lane6(const Cg6Problem& p, const Ws& w, int e, int a) {
  Pose xi, xj, z;
  M6 W;
  float huber = -1.f;
  float* aij;
  if (e < p.c) {
    xi = ld_pose(p.poses, e);
    xj = ld_pose(p.poses, e + 1);
    z = ld_pose(p.cz, e);
    W = ld36(p.cW, e);
    aij = w.cAij + 36LL * e;
  } else {
    const int l = e - p.c;
    xi = ld_pose(p.poses, p.li[l]);
    xj = ld_pose(p.poses, p.lj[l]);
    z = ld_pose(p.lz, l);
    W = ld36(p.lW, l);
    huber = p.huber_delta;
    aij = p.Aij + 36LL * l;
  }
  V6 rw;
  M6 Jiw, Jjw;
  linearize_edge(xi, xj, z, W, huber, rw, Jiw, Jjw);
  float* out = w.blk + 84LL * e;
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float s0 = 0.f, s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s0 += Jiw.m[6 * k + a] * Jjw.m[6 * k + c];
#pragma unroll
    for (int k = 0; k < 6; ++k) s1 += Jiw.m[6 * k + a] * Jiw.m[6 * k + c];
#pragma unroll
    for (int k = 0; k < 6; ++k) s2 += Jjw.m[6 * k + a] * Jjw.m[6 * k + c];
    aij[6 * a + c] = s0;
    out[6 * a + c] = s1;
    out[36 + 6 * a + c] = s2;
  }
  float g0 = 0.f, g1 = 0.f;
#pragma unroll
  for (int k = 0; k < 6; ++k) g0 += Jiw.m[6 * k + a] * rw.v[k];
#pragma unroll
  for (int k = 0; k < 6; ++k) g1 += Jjw.m[6 * k + a] * rw.v[k];
  out[72 + a] = g0;
  out[78 + a] = g1;
}

constexpr int kRowThreads6 = 64;"""
K7A_GROUP_LOOP = """  {  // a group of 6 threads an edge, 5 groups a warp
    const int lane = threadIdx.x & 31;
    const int slot = (threadIdx.x >> 5) * 5 + lane / 6;
    const long long per = blockDim.x / 32 * 5, E = (long long)p.c + p.El;
    for (long long e = blockIdx.x * per + slot; lane < 30 && e < E; e += gridDim.x * per)
      linearize_lane6(p, w, (int)e, lane % 6);
  }"""
K7A_ROWS = ("__device__ __forceinline__ void linearize_row6(",
            "__device__ __noinline__ void assemble_row6(")
K7A_SHAPES = {
    **{f"k7a-threads{t}": [("constexpr int kRowThreads6 = 32;",
                            f"constexpr int kRowThreads6 = {t};", 1)] for t in (64, 128)},
    "k7a-groups6": [
        ("constexpr int kRowThreads6 = 32;", K7A_GROUP_LANE, 1),
        ("  for_flat(p.c + p.El, [&](int e) { linearize_row6(p, w, e); });", K7A_GROUP_LOOP, 1),
        ("return pass_shape(kernel, kRowThreads6, kRowThreads6, n, sh);",
         "return pass_shape(kernel, kRowThreads6, kRowThreads6 / 32 * 5, n, sh);", 1)],
    # the linearize row as one __noinline__ body that the staged and the
    # persistent kernels call; the assemble row inlined into both
    "k7a-noinline-linearize": [(K7A_ROWS[0], K7A_ROWS[0].replace("__forceinline__",
                                                                 "__noinline__"), 1)],
    "k7a-inline-assemble": [(K7A_ROWS[1], K7A_ROWS[1].replace("__noinline__",
                                                              "__forceinline__"), 1)],
    # the two rows swapped: linearize __noinline__, assemble inlined
    "k7a-swapped-inline": [(K7A_ROWS[0], K7A_ROWS[0].replace("__forceinline__",
                                                             "__noinline__"), 1),
                           (K7A_ROWS[1], K7A_ROWS[1].replace("__noinline__",
                                                             "__forceinline__"), 1)],
}
# K8's launch shape (csrc/icp_kernel.cu) and the copies that take another:
# {tree: [(kept text, its replacement, occurrences), ...]}.
K8_SHAPES = {
    f"k8-g{g}-t{t}": [("constexpr int kNnGroup = 16;", f"constexpr int kNnGroup = {g};", 1),
                      ("constexpr int kNnThreads = 256;", f"constexpr int kNnThreads = {t};", 1)]
    for g in (4, 8, 16, 32) for t in (128, 256, 1024) if (g, t) != (16, 256)
}
# The kernel sources each part needs built.
NEEDS = {"replay": ["gn_kernel", "icp_kernel"], "dist": ["gn_kernel", "cg_step", "cg_step6"],
         "k4": ["gn6_kernel"], "k2": ["icp_kernel"], "k5": ["gn6_kernel"], "k6": ["cg_step"],
         "k7": ["cg_step6"], "k7a": ["cg_step6"], "k8": ["icp_kernel"]}


def _seconds(torch, fn, reps: int, chain: int) -> float:
    """Median seconds of `chain` back-to-back calls over `reps` reps."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(chain):
            fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def child_replay(torch):
    import numpy as np
    from graphslam_tpu_torch.config import SLAMConfig, SolverConfig
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.sim import simulate_trajectory
    from graphslam_tpu_torch.slam.pipeline import _solve_buckets, graph_view, make_slam_replay
    from graphslam_tpu_torch.slam.state import init_state

    cfg = SLAMConfig(max_keyframes=1024, max_factors=1024, solve_iterations=4,
                     solver=SolverConfig(mode="gn_fused", cg_max_iterations=12))
    sim = simulate_trajectory(cfg.frontend, step_len=0.25, seed=1)
    n = min(300, len(sim["scans"]))
    dev = torch.device("cuda")
    scans = torch.from_numpy(sim["scans"][:n]).to(dev)
    odom = torch.from_numpy(np.concatenate(
        [np.zeros((1, 3), np.float32), sim["odom_deltas"][: n - 1]])).to(dev)
    replay = make_slam_replay(cfg, n)
    out = {"replay_fps": n / _seconds(torch, lambda: replay(init_state(cfg), scans, odom), 3, 1)}

    # K1's C entry at the replay's own last solve: the final map in its
    # bucket, the warm iterations at the replay's cg, exact PCR
    state, _ = replay(init_state(cfg), scans, odom)
    nkf = int(state.num_kf)
    digest = hashlib.sha256(state.kf_poses[:nkf].cpu().numpy().tobytes())
    digest.update(f"{nkf} {int(state.num_loops)}".encode())
    out["replay_digest"] = digest.hexdigest()[:16]
    B = next(b for b in _solve_buckets(cfg.max_keyframes, cfg.solve_bucket_min)
             if b >= int(state.num_kf))
    p0 = state.kf_poses[:B].clone()
    cg = cfg.solver.cg_max_iterations
    kern = gk.GnKernel(p0, graph_view(state, cfg, B), -1.0, cfg.solver.pcr_levels, cg_max=cg)
    phases = ((cfg.solve_iterations, cg),)

    def solve():
        kern.poses.copy_(p0)
        kern.solve(phases, True)
    solve()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(50):
        solve()
    b.record()
    b.synchronize()
    out["k1_replay_solve_ms"] = a.elapsed_time(b) / 50
    return out


def child_dist(torch):
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.parallel import dist_fused6_gn_solve, dist_fused_gn_solve, make_mesh

    dev = torch.device("cuda")
    mesh = make_mesh()
    out = {}
    for name, solve, iters, cfg in (
            ("dist_fused_m3500", dist_fused_gn_solve, 200,
             SolverConfig(cg_max_iterations=25, pcr_levels=4, edge_tile=512, hvp_splits=1)),
            ("dist_fused6_sphere2500", dist_fused6_gn_solve, 20,
             SolverConfig(cg_max_iterations=25, edge_tile=256, hvp_splits=1))):
        d = getattr(datasets, name.rsplit("_", 1)[1])()
        g, p0 = from_dataset(d, device=dev), torch.from_numpy(d["poses"]).to(dev)
        sec = _seconds(torch, lambda: solve(p0, g, mesh, cfg, iterations=iters), 3, 2) / 2
        out[f"{name}_it_s"] = iters / sec
    torch.distributed.destroy_process_group()
    return out


def child_k4(torch):
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import gn6_kernel as g6

    dev = torch.device("cuda")
    out = {}
    for name in ("sphere2500", "garage"):
        d = getattr(datasets, name)()
        g, p0 = from_dataset(d, device=dev), torch.from_numpy(d["poses"]).to(dev)
        runs = [(f"k4_{name}_gn_ms", lambda: g6.fused_gn6_solve(p0, g, 20, 25))]
        if name == "garage":
            runs.append((f"k4_{name}_lm_ms", lambda: g6.fused_lm6_solve(
                p0, g, 20, 25, huber_delta=1.0)))
        for key, fn in runs:
            out[key] = 1e3 * _seconds(torch, fn, 3, 5) / 5
        lib = g6.Gn6Kernel.load()
        if hasattr(lib, "gn6_wide_ctas"):  # a tree with the wide kernels
            out[f"k4_{name}_ctas"] = lib.gn6_wide_ctas(p0.shape[0])  # < 0: a grid
    return out


def _event_us(torch, fn, reps: int) -> float:
    """Microseconds a call of fn, by CUDA events around `reps` calls after
    3 warm-up calls."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(reps):
        fn()
    b.record()
    b.synchronize()
    return 1e3 * a.elapsed_time(b) / reps


def child_k2(torch):
    import ctypes

    import numpy as np
    from graphslam_tpu_torch.config import FrontendConfig
    from graphslam_tpu_torch.frontend import icp
    from graphslam_tpu_torch.frontend.projection import beam_angles, scan_to_points
    from graphslam_tpu_torch.ops import icp_kernel as ik
    from graphslam_tpu_torch.sim import simulate_trajectory

    fc = FrontendConfig()
    sim = simulate_trajectory(fc, step_len=0.25, seed=1)
    dev = torch.device("cuda")
    angles = beam_angles(fc.num_beams, fc.fov_rad, device=dev)
    (sp, sm), (tp, tm) = (scan_to_points(torch.from_numpy(sim["scans"][t]).to(dev), angles,
                                         fc.min_range, fc.max_range, fc.max_points)
                          for t in (1, 0))
    init = torch.from_numpy(np.asarray(sim["odom_deltas"][0], np.float32)).to(dev)
    Cs, Ct = icp.surfel_covs(sp, sm, 4, 1e-3), icp.surfel_covs(tp, tm, 4, 1e-3)
    lib = ik._lib()
    moved, jtheta = ik._round_inputs(sp, init)
    rprob, rkeep = ik._problem(moved, jtheta, ik.rotated_covs(ik._packed(Cs), init[2]), sm, tp,
                               tm, ik._packed(Ct), 1.0, 1e-6)
    mprob, mkeep = ik._problem(sp, None, ik._packed(Cs), sm, tp, tm, ik._packed(Ct), 1.0, 1e-6,
                               1e-5)
    delta = init.clone()
    mprob.delta = delta.data_ptr()

    def match(fn="icp_match"):
        delta.copy_(init)
        getattr(lib, fn)(ctypes.byref(mprob), 32, 1)

    def digest(match_fn, round_fn):
        h = hashlib.sha256()
        match(match_fn)
        getattr(lib, round_fn)(ctypes.byref(rprob))
        torch.cuda.synchronize()
        for t in (delta, mkeep[9], mkeep[10], rkeep[9]):  # delta, out, ctrl; a round's out
            h.update(t.cpu().numpy().tobytes())
        return h.hexdigest()[:16]
    out = {"k2_digest": digest("icp_match", "icp_iteration")}
    if hasattr(lib, "icp_match_staged"):
        out["k2_staged_digest"] = digest("icp_match_staged", "icp_iteration_staged")
    return {**out,
        "k2_round_us": _event_us(torch, lambda: lib.icp_iteration(ctypes.byref(rprob)), 500),
        "k2_match_us": _event_us(torch, match, 200),
        "k2_gicp_match_us": _event_us(torch, lambda: icp.gicp_match(
            sp, sm, tp, tm, init_delta=init, iterations=32), 50),
    }


def child_k5(torch):
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import pcg6_kernel as p6
    from graphslam_tpu_torch.solver import lm

    dev = torch.device("cuda")
    d = datasets.garage()
    g, p0 = from_dataset(d, device=dev), torch.from_numpy(d["poses"]).to(dev)
    cfg = SolverConfig(mode="pcg_fused", cg_max_iterations=25, max_iterations=20,
                       use_huber_on_loops=True)
    sysm = lm._linearized_system(p0, g, cfg)
    lam = torch.tensor(cfg.init_lambda, device=dev)
    out = {"k5_wrapper_us": _event_us(torch, lambda: p6.fused_pcg6_solve(
        sysm, lam, max_iters=25, chain_prefix=g.chain_prefix), 50)}
    out["k5_garage_lm_it_s"] = cfg.max_iterations / _seconds(
        torch, lambda: lm.lm_solve(p0, g, cfg), 3, 1)
    return out


def _k67_digest(torch, Kernel, make_shard, pk, K, p0, lam, staged) -> str:
    """A digest of two ranks' stage A, setup and 26 CG passes with Huber
    (half the loop edges each, the chain on rank 0, the all-reduces summed
    here), both ranks' outputs: through the entries named in staged, of
    "stage_a", "gn_setup" and "cg_step", as their staged sequences."""
    half = pk.El // 2
    kerns = [Kernel(make_shard(pk, 0, half, K, 1.0, 1.0)),
             Kernel(make_shard(pk, half, pk.El, K, 0.0, 1.0))]

    def entry(k, name):
        return getattr(k, f"{name}_staged" if name in staged else name)

    outs = [t.clone() for k in kerns for t in entry(k, "stage_a")(p0)]
    reduced = outs[0] + outs[2]
    sts = [entry(k, "gn_setup")(reduced, p0, lam) for k in kerns]
    outs += [t.clone() for st in sts for t in st]
    carries = [k.cg_state(sts[0].b) for k in kerns]
    for _ in range(26):
        for k, c in zip(kerns, carries):
            entry(k, "cg_step")(k.Aij, c)
        big = carries[0].big + carries[1].big
        for c in carries:
            c.big.copy_(big)
    outs += [t for c in carries for t in c]
    h = hashlib.sha256()
    for t in outs:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def child_k6(torch):
    import ctypes

    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.parallel import cg_step as cs

    dev = torch.device("cuda")
    d = datasets.m3500()
    g, p0 = from_dataset(d, device=dev), torch.from_numpy(d["poses"]).to(dev)
    pk, K = gk.pack_graph(g, p0.shape[0]), 4
    lam = torch.tensor([1e-3], device=dev)
    kern = cs.CgStepKernel(cs.make_shard(pk, 0, pk.El, K, 1.0, -1.0))
    lib = kern.lib
    staged = hasattr(lib, "cg_stage_a_staged")  # a tree with the persistent K6a/K6b
    out = {"k6_digest": _k67_digest(torch, cs.CgStepKernel, cs.make_shard, pk, K, p0, lam, ())}
    if staged:
        out["k6_staged_digest"] = _k67_digest(torch, cs.CgStepKernel, cs.make_shard, pk, K, p0,
                                              lam, ("stage_a", "gn_setup", "cg_step"))
    if hasattr(lib, "cg_row_ctas"):  # < 0: a grid
        lib.cg_row_ctas.argtypes = [ctypes.c_longlong]
        out["k6a_ctas"] = lib.cg_row_ctas(max(pk.N, pk.c + pk.El))
        out["k6b_ctas"] = lib.cg_row_ctas(pk.N)
    pay, _ = kern.stage_a(p0)
    kern.gn_setup(pay, p0, lam)
    kern.prob.stream = torch.cuda.current_stream(dev).cuda_stream
    prob = ctypes.byref(kern.prob)
    for key, fn, a in (("k6a", "cg_stage_a", ()), ("k6b", "cg_gn_setup", (lam.data_ptr(),))):
        out[f"{key}_entry_us"] = _event_us(torch, lambda: getattr(lib, fn)(prob, *a), 200)
        if staged:
            out[f"{key}_staged_us"] = _event_us(
                torch, lambda: getattr(lib, f"{fn}_staged")(prob, *a), 200)
    return out


def child_k7(torch):
    import ctypes

    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import gn6_kernel as g6
    from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for
    from graphslam_tpu_torch.parallel import cg_step6 as cs6

    dev = torch.device("cuda")
    d = datasets.sphere2500()
    g, p0 = from_dataset(d, device=dev), torch.from_numpy(d["poses"]).to(dev)
    N = p0.shape[0]
    pk, K = g6.pack_graph6(g, N), pcr_levels_for(N, None)
    lam = torch.tensor([1e-3], device=dev)

    kern = cs6.CgStep6Kernel(cs6.make_shard6(pk, 0, pk.El, K, 1.0, -1.0))
    lib = kern.lib
    staged = hasattr(lib, "cg6_step_staged")  # a tree with the persistent K7b/K7c
    out = {"k7_digest": _k67_digest(torch, cs6.CgStep6Kernel, cs6.make_shard6, pk, K, p0, lam, ())}
    if staged:
        out["k7_staged_digest"] = _k67_digest(torch, cs6.CgStep6Kernel, cs6.make_shard6, pk, K,
                                              p0, lam, ("gn_setup", "cg_step"))
        out["k7_ctas"] = lib.cg6_wide_ctas(N)  # < 0: a grid
    pay, _ = kern.stage_a(p0)
    kern.cg_state(kern.gn_setup(pay, p0, lam).b)  # the carry cg6_step runs on
    kern.prob.stream = torch.cuda.current_stream(dev).cuda_stream
    prob, args = ctypes.byref(kern.prob), kern._step_args[1:]
    entries = {"k7b": ("cg6_gn_setup", (lam.data_ptr(),), 100),
               "k7c": ("cg6_step", args, 500)}
    for key, (fn, a, reps) in entries.items():
        out[f"{key}_entry_us"] = _event_us(torch, lambda: getattr(lib, fn)(prob, *a), reps)
        if staged:
            out[f"{key}_staged_us"] = _event_us(
                torch, lambda: getattr(lib, f"{fn}_staged")(prob, *a), reps)
    return out


def child_k7a(torch):
    import ctypes

    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import gn6_kernel as g6
    from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for
    from graphslam_tpu_torch.parallel import cg_step6 as cs6

    dev = torch.device("cuda")
    out = {}
    for name in ("sphere2500", "garage"):
        d = getattr(datasets, name)()
        g, p0 = from_dataset(d, device=dev), torch.from_numpy(d["poses"]).to(dev)
        N = p0.shape[0]
        pk, K = g6.pack_graph6(g, N), pcr_levels_for(N, None)
        kern = cs6.CgStep6Kernel(cs6.make_shard6(pk, 0, pk.El, K, 1.0, -1.0))
        lib = kern.lib
        staged = hasattr(lib, "cg6_stage_a_staged")  # a tree with the persistent K7a
        fns = ("stage_a", "stage_a_staged") if staged else ("stage_a",)
        for fn in fns:
            h, h_aij = hashlib.sha256(), hashlib.sha256()
            for huber in (-1.0, 1.0):
                half = pk.El // 2
                for sh in (cs6.make_shard6(pk, 0, half, K, 1.0, huber),
                           cs6.make_shard6(pk, half, pk.El, K, 0.0, huber)):
                    payload, Aij = getattr(cs6.CgStep6Kernel(sh), fn)(p0)
                    h.update(payload.cpu().numpy().tobytes())
                    h.update(Aij.cpu().numpy().tobytes())
                    h_aij.update(Aij.cpu().numpy().tobytes())
            tag = "staged_" if fn.endswith("staged") else ""
            out[f"k7a_{name}_{tag}digest"] = h.hexdigest()[:16]
            out[f"k7a_{name}_{tag}aij_digest"] = h_aij.hexdigest()[:16]
        kern.prob.stream = torch.cuda.current_stream(dev).cuda_stream
        kern.prob.poses = p0.data_ptr()
        prob = ctypes.byref(kern.prob)
        out[f"k7a_{name}_entry_us"] = _event_us(torch, lambda: lib.cg6_stage_a(prob), 200)
        if staged:
            out[f"k7a_{name}_staged_us"] = _event_us(torch, lambda: lib.cg6_stage_a_staged(prob),
                                                     200)
            lib.cg6_row_ctas.argtypes = [ctypes.c_longlong]
            out[f"k7a_{name}_ctas"] = lib.cg6_row_ctas(max(N, pk.c + pk.El))  # < 0: a grid
    return out


def child_k8(torch):
    import ctypes
    import re

    import numpy as np
    from graphslam_tpu_torch.config import FrontendConfig
    from graphslam_tpu_torch.frontend.projection import beam_angles, scan_to_points
    from graphslam_tpu_torch.ops import icp_kernel as ik
    from graphslam_tpu_torch.sim import simulate_trajectory

    fc = FrontendConfig()
    sim = simulate_trajectory(fc, step_len=0.25, seed=1)
    dev = torch.device("cuda")
    angles = beam_angles(fc.num_beams, fc.fov_rad, device=dev)
    (sp, _), (tp, tm) = (scan_to_points(torch.from_numpy(sim["scans"][t]).to(dev), angles,
                                        fc.min_range, fc.max_range, fc.max_points)
                         for t in (1, 0))
    init = torch.from_numpy(np.asarray(sim["odom_deltas"][0], np.float32)).to(dev)
    src = ik._round_inputs(sp, init)[0].contiguous()
    P, Q = src.shape[0], tp.shape[0]
    lib = ik._lib()
    entries = {"nn_search": "nn_search"}
    out = {}
    if hasattr(lib, "nn_search_serial"):  # a tree with the redesigned K8
        entries["serial"] = "nn_search_serial"
        text = (Path(ik.__file__).resolve().parent.parent / "csrc" / "icp_kernel.cu").read_text()
        out["k8_shape"] = [int(re.search(rf"constexpr int {c} = (\d+);", text).group(1))
                           for c in ("kNnGroup", "kNnThreads")]
    bufs = {k: (torch.empty(P, dtype=torch.int32, device=dev),
                torch.empty(P, dtype=torch.float32, device=dev)) for k in entries}

    def call(key):
        idx, d2 = bufs[key]
        args = (src.data_ptr(), tp.data_ptr(), tm.data_ptr(), idx.data_ptr(), d2.data_ptr(), P, Q)
        return lambda stream: getattr(lib, entries[key])(*args, ctypes.c_void_p(stream))
    for key in entries:
        if call(key)(torch.cuda.current_stream(dev).cuda_stream):
            raise RuntimeError(f"K8 {key}: a CUDA error")
    torch.cuda.synchronize()
    for key, (idx, d2) in bufs.items():
        h = hashlib.sha256(idx.cpu().numpy().tobytes())
        h.update(d2.cpu().numpy().tobytes())
        out[f"k8_{key}_digest"] = h.hexdigest()[:16]
    times = {f"{k}_{how}": [] for k in entries for how in ("us", "call_us")}
    for key in list(entries) + list(entries)[::-1]:
        times[f"{key}_us"].append(_graph_us(torch, call(key)))
        launch = call(key)
        times[f"{key}_call_us"].append(_event_us(
            torch, lambda: launch(torch.cuda.current_stream().cuda_stream), 500))
    out.update({f"k8_{k}": min(v) for k, v in times.items()})
    return out


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


def child(tree: str, what: str) -> int:
    sys.path.insert(0, tree)
    import torch

    import graphslam_tpu_torch
    from graphslam_tpu_torch.ops import _build

    if Path(graphslam_tpu_torch.__file__).resolve().parent.parent != Path(tree).resolve():
        raise RuntimeError(f"imported {graphslam_tpu_torch.__file__}, not the tree {tree}")
    parts = what.split(",")
    _build.build_all(sorted({name for part in parts for name in NEEDS[part]}))
    out = {}
    for part in parts:
        out.update({"replay": child_replay, "dist": child_dist, "k4": child_k4, "k2": child_k2,
                    "k5": child_k5, "k6": child_k6, "k7": child_k7, "k7a": child_k7a,
                    "k8": child_k8}[part](torch))
    print(json.dumps(out), flush=True)
    return 0


def edited_tree(label: str, source: str, edits) -> Path:
    """This checkout's package copied under its build directory as tree
    `label`, with each edit (old, new, count) of `edits` made in
    csrc/<source>: the `count` occurrences of `old` replaced by `new`."""
    dst = ROOT / "graphslam_tpu_torch" / "build" / label
    pkg = dst / "graphslam_tpu_torch"
    shutil.rmtree(dst, ignore_errors=True)
    shutil.copytree(ROOT / "graphslam_tpu_torch", pkg,
                    ignore=shutil.ignore_patterns("build", "__pycache__"))
    path = pkg / "csrc" / source
    text = path.read_text()
    for old, new, count in edits:
        if text.count(old) != count:
            raise RuntimeError(f"{old!r} not found {count} times in {path}")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", help="root of another checkout to compare with")
    ap.add_argument("--rounds", type=int, default=1)
    ap.add_argument("--parts", default="replay,dist,k4,k2,k5,k6,k7,k7a,k8")
    ap.add_argument("--trees", help="the copies to run besides this tree and the parent "
                    "(comma-separated labels; default: every copy the parts take)")
    ap.add_argument("--child", help=argparse.SUPPRESS)
    ap.add_argument("--what", default="replay,dist,k4", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        return child(args.child, args.what)
    import torch

    if not torch.cuda.is_available():
        print("bench_persistent: no CUDA device", file=sys.stderr)
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip()
    print(f"card: {card}; torch {torch.__version__}", flush=True)
    parts = args.parts.split(",")
    trees = {"this": (ROOT, args.parts)}
    shape_parts = ",".join(p for p in ("k4", "k6", "k7") if p in parts)
    if shape_parts:
        trees["other-shape"] = (edited_tree("other-shape", "persistent.cuh", SHAPE_RULE),
                                shape_parts)
    if "k6" in parts:
        for label, edit in K6_SHAPES.items():
            trees[label] = (edited_tree(label, "cg_step.cu", edit), "k6")
    if "k2" in parts:
        for label, edit in K2_SHAPES.items():
            trees[label] = (edited_tree(label, "icp_kernel.cu", edit), "k2")
    if "k7a" in parts:
        for label, edit in K7A_SHAPES.items():
            trees[label] = (edited_tree(label, "cg_step6.cu", edit), "k7a")
    if "k8" in parts:
        for label, edit in K8_SHAPES.items():
            trees[label] = (edited_tree(label, "icp_kernel.cu", edit), "k8")
    if args.trees is not None:
        keep = set(args.trees.split(",")) - {""}
        unknown = keep - set(trees)
        if unknown:
            print(f"bench_persistent: no copy {sorted(unknown)} for these parts", file=sys.stderr)
            return 2
        trees = {k: v for k, v in trees.items() if k == "this" or k in keep}
    order = list(trees)
    if args.parent:
        trees["parent"] = (Path(args.parent).resolve(), args.parts)
        order = ["parent"] + order
    results = {k: [] for k in trees}
    for _ in range(args.rounds):
        for label in order + order[::-1]:
            tree, what = trees[label]
            proc = subprocess.run([sys.executable, str(Path(__file__).resolve()), "--child",
                                   str(tree), "--what", what], capture_output=True, text=True,
                                  cwd=str(tree))
            if proc.returncode != 0:
                print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n", file=sys.stderr)
                print(f"{label}: exit {proc.returncode}", file=sys.stderr)
                return 1
            res = json.loads(proc.stdout.strip().splitlines()[-1])
            results[label].append(res)
            print(f"{label}: " + ", ".join(f"{k} {v:.3f}" if isinstance(v, float) else f"{k} {v}"
                                           for k, v in res.items()), flush=True)
    print(json.dumps({"card": card, "results": results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
