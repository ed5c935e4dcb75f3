#!/usr/bin/env python3
"""Rehearse the CUDA sources in graphslam_tpu_torch/csrc/ on the CPU, without a GPU or nvcc.

Usage:  python scripts/emulate_gn_kernel.py [--poses N]
        python scripts/emulate_gn_kernel.py --se3 [--rings R --per-ring P]
        python scripts/emulate_gn_kernel.py --dist [--poses N]
        python scripts/emulate_gn_kernel.py --dist6 [--rings R --per-ring P]
        python scripts/emulate_gn_kernel.py --persistent
               [--kernels k3,k6c,k6ab,k1,k4,k5,k7a,k7b,k7c,k2,k8]
               [--poses N[,N...]] [--rings R[,R...] --per-ring P[,P...]]
               [--max-cluster C] [--unplaceable]
        python scripts/emulate_gn_kernel.py --vs-tree DIR [--poses N]
               [--rings R --per-ring P]
        (each takes --build-dir DIR; default graphslam_tpu_torch/build/emu/)

Rewrites every `k<<<grid, block, 0, s>>>(` launch of the CUDA source into a
call of a C++ emulation (blocks in turn, each thread of a block a fiber
on the calling thread, meeting at counting barriers for __syncthreads,
__syncwarp and the shuffles) and every `__shared__` declaration into one
copy per CTA, compiles it with g++ against the emulation header below
(kept here; it also maps a cluster or cooperative cudaLaunchKernelEx onto
a launch of every thread of every CTA at once, and cluster.sync() and
grid.sync() onto barriers over all of them),
loads it in place of the nvcc build and drives the port's own wrappers on
CPU tensors, each against its plain torch twin:

  default  gn_kernel.cu: K1's GN and LM modes (GnKernel) and K3
           (PcgKernel) on manhattan(N), and K3 bitwise against its staged
           sequence (as --persistent); under a minute at N = 260
  --se3    gn6_kernel.cu: K4's stages (Gn6Kernel: assembly, PCR apply, CG),
           its GN mode plain, chain-only, masked and warm, its LM mode and
           cost pass, and K5 (Pcg6Kernel) on sphere(R, P); a few minutes at
           sphere(6, 8)
  --dist   cg_step.cu: K6a, K6b and K6c (CgStepKernel) on two ranks'
           shards of manhattan(N) (half the loop edges each, the chain
           weighted 1 on rank 0 and 0 on rank 1; without and with Huber;
           the all-reduces summed here), K6c after 1 and 26 passes,
           and the kernel path of dist_fused_gn_solve / dist_fused_lm_solve
           on a one-rank gloo mesh against the plain path; K6c bitwise
           against cg_step_staged (as --persistent)
  --dist6  cg_step6.cu: the same for K7a, K7b and K7c (CgStep6Kernel) on
           two ranks' shards of sphere(R, P) at exact PCR, and the kernel
           path of dist_fused6_gn_solve / dist_fused6_lm_solve; about a
           minute at sphere(6, 8)
  --persistent  the persistent kernels of --kernels against their staged
           sequences with torch.equal: K3 (gn_factor + gn_cg) at lam 0 and
           1e-3, masked and chain-only, K6c (cg_step_staged) on two ranks
           without and with Huber after 1 and 26 passes, K6a and K6b
           (stage_a_staged, gn_setup_staged; k6ab) on two ranks without
           Huber at lam 0, with Huber at lam 1e-3 and with a chain-only
           rank, both ranks' payloads, Aij and Setups, K1 and K4
           (gn_solve_staged, gn_lm_solve_staged and their gn6 twins) in GN
           mode with warm start and a cg ramp and in LM mode with Huber, K5
           (gn6_factor + gn6_cg) at lam 0 and at 1e-3 masked, K7a
           (cg6_stage_a_staged) on two ranks without and with Huber,
           masked and with a chain-only rank 0, both ranks' payloads and
           Aij, K7b and K7c
           (cg6_gn_setup_staged, cg6_step_staged) on two ranks, with and
           without Huber, at lam 0 and 1e-3, masked and chain-only, the
           Setup and the whole carry after 1 and 26 passes, K2
           (icp_match_staged, icp_iteration_staged) bit for bit on a
           simulated scan pair and random points (k2_persistent_checks),
           K8 (nn_search against nn_search_serial) bit for bit on random
           points, ties, duplicate targets, no valid target, 1700 targets,
           NaN and infinite points (k8_persistent_checks).
           One build serves every size: lists of sizes give one JSON line
           each (size i: manhattan(N_i), sphere(R_i, P_i)), K2 and K8 one
           line of their own first. --max-cluster
           C caps the cluster, and the emulated card's SMs, at C CTAs, so
           that a CTA walks several row blocks or passes; --unplaceable
           makes the occupancy query place no cluster and checks that
           every persistent entry raises while the staged sequences still
           run (K8's plain grid needs no co-residency: a card that cannot
           place its CTA fails the launch itself)
           (tests/test_torch_persistent_emu.py)
  --vs-tree DIR  gn_kernel.cu, cg_step.cu, gn6_kernel.cu and cg_step6.cu of
           this checkout against those of the checkout DIR (e.g. `git
           archive` of the parent commit): K1 and K4 in GN and LM modes,
           K3, K5 (persistent and staged), K6a-c (persistent and staged)
           and K7a-c (K7b and K7c persistent and staged) held to
           torch.equal; the check of an edit to a shared header or of a new
           launch shape

Prints one JSON line (--persistent: one a size): max errors (poses wrapped or over the 12 entries,
stages and K3/K5 relative to the largest entry) and the LM stats of kernel
and twin, or the bitwise verdicts. Slow: a fiber per emulated CUDA thread.
"""

import argparse
import ctypes
import json
import math
import os
import re
import subprocess
import sys
import tempfile
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

HEADER = r"""#pragma once
#include <cmath>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <functional>
#include <memory>
#include <vector>
#include <ucontext.h>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __grid_constant__
#define __launch_bounds__(...)
#define __shared__ static
struct dim3 {
  unsigned x = 1, y = 1, z = 1;
  dim3() = default;
  dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
inline thread_local dim3 threadIdx, blockIdx, blockDim, gridDim;
struct float4 { float x, y, z, w; };
// Every emulated CUDA thread of a launch is a fiber (ucontext) on the
// calling thread; a barrier switches to the scheduler, which resumes the
// fibers in turn and aborts when none can move (a barrier some thread never
// reaches).
struct EmuBarrier { unsigned expected = 0, count = 0; unsigned long gen = 0; };
struct EmuFiber {
  ucontext_t ctx;
  std::unique_ptr<char[]> stack;
  unsigned index = 0;
  EmuBarrier* wait = nullptr;
  unsigned long wait_gen = 0;
  bool done = false;
};
constexpr size_t kEmuStack = 256 * 1024;
inline thread_local ucontext_t emu_sched;
inline thread_local EmuFiber* emu_cur = nullptr;
inline thread_local EmuBarrier* emu_bar = nullptr;      // the CTA's
inline thread_local EmuBarrier* emu_cluster = nullptr;  // the cluster's
inline thread_local EmuBarrier* emu_warp = nullptr;     // the warp's
inline thread_local float* emu_lanes = nullptr;         // the warp's shuffle slots
inline thread_local const std::function<void(unsigned)>* emu_job = nullptr;
inline void emu_arrive(EmuBarrier* b) {
  if (++b->count == b->expected) {  // the last to arrive releases the rest
    b->count = 0;
    ++b->gen;
    return;
  }
  emu_cur->wait = b;
  emu_cur->wait_gen = b->gen;
  swapcontext(&emu_cur->ctx, &emu_sched);
}
inline void __syncthreads() { emu_arrive(emu_bar); }
inline void __syncwarp(unsigned = 0xffffffffu) { emu_arrive(emu_warp); }
// Every lane of the warp takes part (a full mask). The warp's 64 slots
// alternate by its barrier's generation: a lane writes the next shuffle's
// half only after every lane has left this one's barrier, and the half
// after that only after every lane has read this one's (one barrier a
// shuffle).
inline float __shfl_down_sync(unsigned, float v, unsigned delta) {
  const unsigned lane = threadIdx.x % 32;
  float* slots = emu_lanes + 32 * (emu_warp->gen & 1);
  slots[lane] = v;
  emu_arrive(emu_warp);
  return lane + delta < 32 ? slots[lane + delta] : v;
}
inline int __shfl_down_sync(unsigned mask, int v, unsigned delta) {
  float f;
  std::memcpy(&f, &v, sizeof f);
  f = __shfl_down_sync(mask, f, delta);
  std::memcpy(&v, &f, sizeof v);
  return v;
}
// Rounded float32 operations, as g++ (-ffp-contract=off) computes every one.
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fmul_rn(float a, float b) { return a * b; }
// One barrier and 2 x 32 shuffle slots per warp of a CTA of `block` threads.
struct EmuWarps {
  std::vector<EmuBarrier> bars;
  std::vector<float> lanes;
  EmuWarps(unsigned ctas, unsigned block) : bars(ctas * ((block + 31) / 32)),
                                            lanes(64 * bars.size()) {
    for (size_t i = 0; i < bars.size(); ++i) {
      const unsigned first = 32 * (i % ((block + 31) / 32));
      bars[i].expected = block - first < 32 ? block - first : 32;
    }
  }
  void enter(unsigned cta, unsigned t, unsigned block) {
    const size_t i = cta * ((block + 31) / 32) + t / 32;
    emu_warp = &bars[i];
    emu_lanes = &lanes[64 * i];
  }
};
inline void emu_entry() {
  EmuFiber* f = emu_cur;
  (*emu_job)(f->index);
  f->done = true;
}
// job(i) for i in [0, n), each on its own fiber; enter(i) sets fiber i's
// thread and block indices and barriers before each time it runs.
inline void emu_run(unsigned n, const std::function<void(unsigned)>& job,
                    const std::function<void(unsigned)>& enter) {
  static thread_local std::vector<std::unique_ptr<EmuFiber>> fibers;
  while (fibers.size() < n) {
    fibers.push_back(std::make_unique<EmuFiber>());
    fibers.back()->stack.reset(new char[kEmuStack]);
  }
  emu_job = &job;
  for (unsigned i = 0; i < n; ++i) {
    EmuFiber& f = *fibers[i];
    f.index = i;
    f.wait = nullptr;
    f.done = false;
    getcontext(&f.ctx);
    f.ctx.uc_stack.ss_sp = f.stack.get();
    f.ctx.uc_stack.ss_size = kEmuStack;
    f.ctx.uc_link = &emu_sched;
    makecontext(&f.ctx, emu_entry, 0);
  }
  for (;;) {
    bool all_done = true, moved = false;
    for (unsigned i = 0; i < n; ++i) {
      EmuFiber& f = *fibers[i];
      if (f.done) continue;
      all_done = false;
      if (f.wait && f.wait->gen == f.wait_gen) continue;  // still held
      f.wait = nullptr;
      enter(i);
      emu_cur = &f;
      swapcontext(&emu_sched, &f.ctx);
      moved = true;
    }
    if (all_done) return;
    if (!moved) {
      std::fprintf(stderr, "emulation: deadlock, a barrier that not every thread reaches\n");
      std::abort();
    }
  }
}
// __shared__ variables, one copy per CTA (build() rewrites each declaration)
template <typename T> struct EmuShared {
  T v[64];
  T& get() { return v[blockIdx.x % 64]; }
};
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1,
                   cudaErrorLaunchOutOfResources = 7 };
enum cudaFuncAttribute { cudaFuncAttributeNonPortableClusterSizeAllowed = 9 };
enum cudaLaunchAttributeID { cudaLaunchAttributeCooperative = 2,
                             cudaLaunchAttributeClusterDimension = 4 };
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  struct { struct { unsigned x, y, z; } clusterDim; int cooperative; } val;
};
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
#ifndef EMU_SMS
#define EMU_SMS 132
#endif
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = EMU_SMS; return cudaSuccess; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n); return cudaSuccess; }
template <typename T> cudaError_t cudaFuncSetAttribute(T*, cudaFuncAttribute, int) {
  return cudaSuccess; }
#ifndef EMU_ACTIVE_CLUSTERS
#define EMU_ACTIVE_CLUSTERS 1
#endif
template <typename T>
cudaError_t cudaOccupancyMaxActiveClusters(int* n, T*, const cudaLaunchConfig_t*) {
  *n = EMU_ACTIVE_CLUSTERS; return cudaSuccess; }
template <typename T>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, T*, int, size_t) {
  *n = EMU_ACTIVE_CLUSTERS; return cudaSuccess; }
inline thread_local unsigned emu_cluster_blocks = 1;  // CTAs of this launch's clusters
// A staged launch: blocks in turn, the threads of a block at once.
template <typename K, typename... A>
void emu_launch(int grid, int block, K kernel, A... args) {
  EmuBarrier bar;
  bar.expected = block;
  EmuWarps warps(1, block);
  for (int b = 0; b < grid; ++b) {
    emu_run(block, [&](unsigned) { kernel(args...); }, [&](unsigned t) {
      threadIdx.x = t; blockIdx.x = b; blockDim.x = block; gridDim.x = grid;
      emu_bar = &bar; warps.enter(0, t, block); });
  }
}
// A cluster launch (the grid is one cluster) or a cooperative one (a cluster
// a CTA): every thread of every CTA at once; cluster.sync() of the one
// cluster and grid.sync() are a barrier over all of them, __syncthreads one
// per CTA, __syncwarp and the shuffles one per warp.
template <typename... P, typename... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg, void (*kernel)(P...),
                               A&&... args) {
  const unsigned grid = cfg->gridDim.x, block = cfg->blockDim.x;
  const bool cooperative = cfg->attrs[0].id == cudaLaunchAttributeCooperative;
  EmuBarrier cluster;
  cluster.expected = grid * block;
  std::vector<EmuBarrier> ctas(grid);
  for (auto& c : ctas) c.expected = block;
  EmuWarps warps(grid, block);
  emu_run(grid * block, [&](unsigned) { kernel(args...); }, [&](unsigned i) {
    threadIdx.x = i % block; blockIdx.x = i / block; blockDim.x = block; gridDim.x = grid;
    emu_bar = &ctas[i / block]; emu_cluster = &cluster;
    emu_cluster_blocks = cooperative ? 1 : grid;
    warps.enter(i / block, i % block, block); });
  return cudaSuccess;
}
"""

COOPERATIVE_GROUPS = r"""#pragma once
#include "cuda_runtime.h"
namespace cooperative_groups {
struct cluster_group {
  void sync() const { emu_arrive(emu_cluster); }
  unsigned long long num_blocks() const { return emu_cluster_blocks; }
};
inline cluster_group this_cluster() { return {}; }
struct grid_group {
  void sync() const { emu_arrive(emu_cluster); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups
"""

_LAUNCH = re.compile(r"(\w+(?:<\w+>)?)<<<([^,]+),\s*([^,]+),\s*0,\s*s>>>\(")
_SHARED = re.compile(r"__shared__\s+([\w:<> ]+?)\s+(\w+)((?:\[[^\]]+\])*)\s*;")


def emulated(code: str) -> str:
    """CUDA source -> C++ for the emulation header: each staged launch
    `k<<<grid, block, 0, s>>>(` becomes `emu_launch(grid, block, k, ` and each
    `__shared__ T name[...];` a per-CTA copy."""
    code = _LAUNCH.sub(r"emu_launch(\2, \3, \1, ", code)
    return _SHARED.sub(r"static EmuShared<\1\3> \2_emu_; auto& \2 = \2_emu_.get();", code)


def header_texts(src_root: Path = ROOT) -> dict:
    """{file name: text} of the shared files of a build directory: the
    emulation's cuda_runtime.h and cooperative_groups.h, and the csrc/
    headers of the checkout src_root, rewritten."""
    csrc = Path(src_root) / "graphslam_tpu_torch" / "csrc"
    texts = {"cuda_runtime.h": HEADER, "cooperative_groups.h": COOPERATIVE_GROUPS}
    for hdr in sorted(csrc.glob("*.cuh")):
        texts[hdr.name] = emulated(hdr.read_text())
    return texts


def write_if_changed(path: Path, text: str) -> None:
    """text into path, through a temporary file beside it and os.replace,
    and only where path does not hold that text already. An unchanged file
    keeps its inode and mtime: GCC's #pragma once tells files apart partly
    by mtime, so a header rewritten under a running g++ is taken for a new
    file and its definitions come twice."""
    try:
        if path.read_text() == text:
            return
    except FileNotFoundError:
        pass
    fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=f".{path.name}.")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(text)
        os.replace(tmp, path)
    except BaseException:
        Path(tmp).unlink(missing_ok=True)
        raise


def write_headers(out: Path, src_root: Path = ROOT) -> None:
    """The shared files of the build directory out (header_texts), each
    written only where its text changed."""
    out.mkdir(parents=True, exist_ok=True)
    for name, text in header_texts(src_root).items():
        write_if_changed(out / name, text)


def _default_out(out) -> Path:
    return Path(out or ROOT / "graphslam_tpu_torch" / "build" / "emu")


def _gxx(name: str, out: Path, src_root: Path, max_cluster: int, unplaceable: bool):
    """(library path, g++ command) of csrc/<name>.cu of the checkout
    src_root, its rewritten source written into out beside the shared
    headers."""
    csrc = Path(src_root) / "graphslam_tpu_torch" / "csrc"
    (out / f"{name}_emu.cpp").write_text(emulated((csrc / f"{name}.cu").read_text()))
    lib = out / f"lib{name}_emu.so"
    cmd = ["g++", "-std=c++20", "-O1", "-ffp-contract=off", "-shared", "-fPIC", f"-I{out}",
           "-o", str(lib),
           str(out / f"{name}_emu.cpp")]
    if max_cluster:
        cmd[1:1] = [f"-DPERSISTENT_MAX_CLUSTER={max_cluster}", f"-DEMU_SMS={max_cluster}"]
    if unplaceable:
        cmd.insert(1, "-DEMU_ACTIVE_CLUSTERS=0")
    return lib, cmd


def build(name: str = "gn_kernel", out: Path = None, src_root: Path = ROOT,
          max_cluster: int = 0, unplaceable: bool = False) -> Path:
    """g++-build csrc/<name>.cu of the checkout src_root under the emulation
    into out (default graphslam_tpu_torch/build/emu/); its csrc/ headers are
    rewritten beside it. max_cluster > 0 caps the persistent kernels' CTAs
    (PERSISTENT_MAX_CLUSTER, and the emulated card's SMs for a cooperative
    grid of one CTA an SM) so that a CTA walks several blocks at small N;
    unplaceable makes the occupancy query place no cluster. Returns the
    library's path."""
    out = _default_out(out)
    write_headers(out, src_root)
    lib, cmd = _gxx(name, out, src_root, max_cluster, unplaceable)
    subprocess.run(cmd, check=True)
    return lib


def build_all(specs: dict, max_cluster: int = 0, unplaceable: bool = False) -> dict:
    """build() of every {key: (name, out, src_root)} at once: the shared
    headers of every build directory written first, then one g++ a source,
    all started together, so that no g++ reads a header while it is being
    written. Returns {key: library path}; exits where a g++ failed."""
    roots = {}
    for name, out, src_root in specs.values():
        out = _default_out(out)
        if roots.setdefault(out, Path(src_root)) != Path(src_root):
            raise ValueError(f"two checkouts' headers in one build directory {out}")
    for out, src_root in roots.items():
        write_headers(out, src_root)
    cmds = {key: _gxx(name, _default_out(out), src_root, max_cluster, unplaceable)
            for key, (name, out, src_root) in specs.items()}
    procs = [subprocess.Popen(cmd) for _, cmd in cmds.values()]
    if any([proc.wait() for proc in procs]):
        raise SystemExit("g++ failed")
    return {key: lib for key, (lib, _) in cmds.items()}


def load_ops(libs, names=("gn_kernel", "pcg_kernel")):
    """The port's ops modules `names`, with the emulated libraries `libs`
    ({source name: path}) in place of the nvcc builds and the CUDA device
    checks dropped (icp_kernel's entries launch the kernels for CPU tensors
    too)."""
    import graphslam_tpu_torch.ops as ops_pkg
    from graphslam_tpu_torch.ops import _build

    _build.load = lambda name: ctypes.CDLL(str(libs[name]))
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(cuda_stream=0)
    mods = []
    for name in names:
        path = ROOT / "graphslam_tpu_torch" / "ops" / f"{name}.py"
        mod = types.ModuleType(f"graphslam_tpu_torch.ops.{name}")
        mod.__file__ = str(path)
        sys.modules[mod.__name__] = mod
        setattr(ops_pkg, name, mod)
        code = path.read_text().replace('.type != "cuda"', '.type == "never"')
        if name in ("icp_kernel", "correspondence"):
            code = code.replace('.device.type == "cpu"', '.device.type == "never"')
        exec(compile(code, str(path), "exec"), mod.__dict__)
        mods.append(mod)
    return mods


def load_cg_step(libs):
    """parallel/cg_step.py and, with "cg_step6" in libs, parallel/cg_step6.py,
    with the emulated libraries `libs` ({source name: path}) in place of the
    nvcc builds: their wrappers launch the kernels for CPU tensors too.
    Returns (cg_step, cg_step6 or None, dist_fused, dist_fused6)."""
    import graphslam_tpu_torch.parallel as par_pkg
    from graphslam_tpu_torch.ops import _build
    from graphslam_tpu_torch.parallel import dist_fused, dist_fused6

    prev = _build.load
    _build.load = lambda name: ctypes.CDLL(str(libs[name])) if name in libs else prev(name)
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(cuda_stream=0)
    mods = []
    for name in ("cg_step", "cg_step6"):
        path = ROOT / "graphslam_tpu_torch" / "parallel" / f"{name}.py"
        mod = types.ModuleType(f"graphslam_tpu_torch.parallel.{name}")
        mod.__file__ = str(path)
        code = path.read_text().replace('.type != "cuda"', '.type == "never"').replace(
            '.device.type == "cpu"', '.device.type == "never"')
        sys.modules[mod.__name__] = mod
        setattr(par_pkg, name, mod)
        exec(compile(code, str(path), "exec"), mod.__dict__)
        mods.append(mod)
    dist_fused.cs = dist_fused6.cs = mods[0]
    dist_fused6.cs6 = mods[1]
    return mods[0], mods[1], dist_fused, dist_fused6


def kernel_checks(out, make_shard, Kernel, twins, pk, K, p0):
    """The kernels against their twins on two ranks' shards of the packed
    graph pk (half the loop edges each, the chain on rank 0; the
    all-reduces are sums of the two ranks' buffers), without and with
    Huber: stage A per rank, the setup, the CG carry after 1 and 26 passes.
    twins = (stage_a_reference, gn_setup_reference, cg_step_reference)."""
    from graphslam_tpu_torch.parallel.cg_step import cg_state

    stage_ref, setup_ref, step_ref = twins

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max().clamp_min(1e-30))

    half = pk.El // 2
    for label, huber in (("plain", -1.0), ("huber", 1.0)):
        shs = [make_shard(pk, 0, half, K, 1.0, huber), make_shard(pk, half, pk.El, K, 0.0, huber)]
        kerns = [Kernel(sh) for sh in shs]
        got = [tuple(t.clone() for t in k.stage_a(p0)) for k in kerns]
        refs = [stage_ref(sh, p0) for sh in shs]
        for r, ((pay, A), (pay_r, A_r)) in enumerate(zip(got, refs)):
            out[f"stage_a_{label}_rank{r}"] = rel(pay, pay_r)
            out[f"aij_{label}_rank{r}"] = rel(A, A_r)
        reduced = got[0][0] + got[1][0]
        reduced_r = refs[0][0] + refs[1][0]
        lam = torch.tensor([1e-3])
        sts = [k.gn_setup(reduced.clone(), p0, lam) for k in kerns]
        srs = [setup_ref(sh, reduced_r, p0, lam) for sh in shs]
        out[f"setup_{label}"] = max(rel(a, b) for a, b in zip(sts[0], srs[0]))
        cks = [k.cg_state(srs[0].b) for k in kerns]
        crs = [cg_state(srs[0].b) for _ in kerns]
        for it in range(26):
            for k, ck in zip(kerns, cks):
                k.cg_step(k.Aij, ck)
            for sh, sr, (_, A_r), cr in zip(shs, srs, refs, crs):
                step_ref(sh, sr, A_r, cr)
            for carry in (cks, crs):
                big = carry[0].big + carry[1].big
                for c in carry:
                    c.big.copy_(big)
            if it in (0, 25):  # scal[2] is the kernel's scratch slot
                out[f"cg{it + 1}_{label}"] = max(
                    rel(a, b) for a, b in zip(cks[0]._replace(scal=cks[0].scal[:2]),
                                              crs[0]._replace(scal=crs[0].scal[:2])))


def main_dist(n: int) -> None:
    """cg_step.cu: K6a, K6b and K6c against their twins on two ranks'
    shards of manhattan(n), and the kernel path of dist_fused_gn_solve /
    dist_fused_lm_solve (one rank) against the twins' path."""
    cs, _, df, _ = load_cg_step({"cg_step": build("cg_step")})
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.parallel import make_mesh

    data = datasets.manhattan(n_poses=n, loop_prob=0.25, seed=0)
    g = from_dataset(data, device="cpu")
    p0 = torch.from_numpy(data["poses"])
    pk = gk.pack_graph(g, n)
    out = {"poses": n, "loop_edges": pk.El}
    kernel_checks(out, cs.make_shard, cs.CgStepKernel,
                  (cs.stage_a_reference, cs.gn_setup_reference, cs.cg_step_reference), pk, 4, p0)
    k6c_persistent_checks(out, cs, pk, p0, 4)
    mesh = make_mesh(device="cpu")
    cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4)
    kern_out = df.dist_fused_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    twin_out = df._dist_fused(p0, g, mesh, 3, 25, -1.0, 4, cfg.edge_tile, False, 0.0, 10.0,
                              1e-10, 1e7, False)[0]
    out["gn_vs_plain"] = wrapped_max(kern_out, twin_out)
    lm_cfg = SolverConfig(cg_max_iterations=25, pcr_levels=4, use_huber_on_loops=True)
    a, sa = df.dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=True)
    b, sb = df.dist_fused_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=False)
    out["lm_vs_plain"] = wrapped_max(a, b)
    out["lm_stats"] = [[float(t) for t in sa], [float(t) for t in sb]]
    out["launches"] = [cs.stage_a.launches, cs.gn_setup.launches, cs.cg_step.launches]
    print(json.dumps(out))


def main_dist6(rings: int, per_ring: int) -> None:
    """cg_step6.cu: K7a, K7b and K7c against their twins on two ranks'
    shards of sphere(rings, per_ring) at exact PCR, and the kernel path of
    dist_fused6_gn_solve / dist_fused6_lm_solve (one rank) against the plain
    path."""
    _, cs6, _, df6 = load_cg_step({"cg_step6": build("cg_step6")})
    from graphslam_tpu_torch.config import SolverConfig
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import gn6_kernel as g6
    from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for
    from graphslam_tpu_torch.parallel import make_mesh

    data = datasets.sphere(n_rings=rings, poses_per_ring=per_ring, seed=1)
    g = from_dataset(data, device="cpu")
    p0 = torch.from_numpy(data["poses"])
    n = p0.shape[0]
    pk = g6.pack_graph6(g, n)
    K = pcr_levels_for(n, None)
    out = {"poses": n, "loop_edges": pk.El, "K": K}
    kernel_checks(out, cs6.make_shard6, cs6.CgStep6Kernel,
                  (cs6.stage_a6_reference, cs6.gn_setup6_reference, cs6.cg_step6_reference),
                  pk, K, p0)
    mesh = make_mesh(device="cpu")
    cfg = SolverConfig(cg_max_iterations=25)
    a = df6.dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=True)
    b = df6.dist_fused6_gn_solve(p0, g, mesh, cfg, iterations=3, cg_kernel=False)
    out["gn_vs_plain"] = float((a - b).abs().max())
    lm_cfg = SolverConfig(cg_max_iterations=25, use_huber_on_loops=True)
    a, sa = df6.dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=True)
    b, sb = df6.dist_fused6_lm_solve(p0, g, mesh, lm_cfg, iterations=3, cg_kernel=False)
    out["lm_vs_plain"] = float((a - b).abs().max())
    out["lm_stats"] = [[float(t) for t in sa], [float(t) for t in sb]]
    out["launches"] = [cs6.stage_a6.launches, cs6.gn_setup6.launches, cs6.cg_step6.launches]
    print(json.dumps(out))


def k3_persistent_checks(out, pk, g, p0):
    """K3 (PcgKernel.solve, one cluster launch) against the staged
    gn_factor + gn_cg on the same problem, bitwise, and two calls bitwise:
    at lam 0 and 1e-3, with masked loop slots clipped onto node 0, and on
    the chain alone."""
    from graphslam_tpu_torch.factors.linearize import linearize
    from graphslam_tpu_torch.solver import normal_eq as ne

    n, c, E = p0.shape[0], g.chain_prefix, g.num_edges
    mask, edges = g.edge_mask.clone(), g.edges.clone()
    mask[c::2] = False
    edges[c::2] = 0  # masked slots clipped onto node 0, as in the online graph
    for name, graph, lam in (("k3", g, 0.0), ("k3_lam1e-3", g, 1e-3),
                             ("k3_masked", g.replace(edge_mask=mask, edges=edges), 0.0),
                             ("k3_chain", g.replace(edge_mask=g.edge_mask & (torch.arange(E) < c)),
                              0.0)):
        sysm = ne.build_blocks(linearize(p0, graph), graph, n)
        kern = pk.PcgKernel(*pk._chain_and_loops(sysm, torch.tensor(lam), True, c), 25)
        a = kern.solve().clone()
        b = kern.staged().clone()
        again = kern.solve().clone()
        out[f"{name}_bitwise"] = bool(torch.equal(a, b) and torch.equal(a, again))
        out[f"{name}_finite"] = bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0


def k6c_persistent_checks(out, cs, pk, p0, K):
    """K6c (cg_step, one cluster launch) against cg_step_staged on two ranks'
    shards of the packed graph pk (half the loop edges each, the chain on
    rank 0, the all-reduces summed here), without and with Huber: the whole
    carry bitwise after 1 and 26 passes."""
    half = pk.El // 2
    lam = torch.tensor([1e-3])
    for label, huber in (("plain", -1.0), ("huber", 1.0)):
        runs = []
        for staged in (False, True):
            shs = [cs.make_shard(pk, 0, half, K, 1.0, huber),
                   cs.make_shard(pk, half, pk.El, K, 0.0, huber)]
            kerns = [cs.CgStepKernel(sh) for sh in shs]
            pays = [k.stage_a(p0)[0].clone() for k in kerns]
            sts = [k.gn_setup(pays[0] + pays[1], p0, lam) for k in kerns]
            carries = [k.cg_state(sts[0].b) for k in kerns]
            snaps = []
            for it in range(26):
                for k, c in zip(kerns, carries):
                    (k.cg_step_staged if staged else k.cg_step)(k.Aij, c)
                big = carries[0].big + carries[1].big
                for c in carries:
                    c.big.copy_(big)
                if it in (0, 25):
                    snaps.append([t.clone() for t in carries[0]])
            runs.append(snaps)
        out[f"k6c_{label}_bitwise"] = all(
            torch.equal(a, b) for sa, sb in zip(*runs) for a, b in zip(sa, sb))
        out[f"k6c_{label}_finite"] = bool(torch.isfinite(runs[0][1][0]).all())


def k6ab_persistent_checks(out, cs, pk, p0, K):
    """K6a (stage_a) and K6b (gn_setup), one cluster launch each, against
    stage_a_staged and gn_setup_staged on two ranks' shards of the packed
    graph pk (the chain on rank 0, the all-reduce summed here), bitwise:
    both ranks' payloads and Aij stashes, and both ranks' Setups. Cases:
    half the loop edges each without Huber at lam 0 and with Huber at lam
    1e-3; a chain-only rank 0 (El = 0) beside a rank 1 with every loop
    edge."""
    half = pk.El // 2
    for name, cut, huber, lam in (("plain", half, -1.0, 0.0), ("huber_lam1e-3", half, 1.0, 1e-3),
                                  ("chain_rank", 0, 1.0, 1e-3)):
        runs = []
        for staged in (False, True):
            kerns = [cs.CgStepKernel(cs.make_shard(pk, 0, cut, K, 1.0, huber)),
                     cs.CgStepKernel(cs.make_shard(pk, cut, pk.El, K, 0.0, huber))]
            outs = [[t.clone() for t in (k.stage_a_staged if staged else k.stage_a)(p0)]
                    for k in kerns]
            reduced = outs[0][0] + outs[1][0]
            sts = [(k.gn_setup_staged if staged else k.gn_setup)(reduced, p0, torch.tensor([lam]))
                   for k in kerns]
            runs.append(([t for o in outs for t in o], [t.clone() for st in sts for t in st]))
        (a, sa), (b, sb) = runs
        out[f"k6a_{name}_bitwise"] = all(torch.equal(x, y) for x, y in zip(a, b))
        out[f"k6b_{name}_bitwise"] = all(torch.equal(x, y) for x, y in zip(sa, sb))
        dinv = sa[4]  # rank 0's Dinv
        out[f"k6b_{name}_finite"] = bool(torch.isfinite(dinv).all()) and float(dinv.abs().max()) > 0


def k7a_persistent_checks(out, cs6, g6, g, p0, lib6):
    """K7a (stage_a, one launch of cg6_stage_a_persistent) against
    stage_a_staged on two ranks' shards of the sphere g (the chain on rank
    0), bitwise: both ranks' payloads and Aij stashes. Cases: half the loop
    edges each without Huber and with Huber, masked loop slots clipped onto
    node 0 (Huber), and a chain-only rank 0 (El = 0) beside a rank 1 with
    every loop edge; and that chain-only rank 0 on sphere(6, 10) (60 rows,
    a cluster where the cap allows it). Also each case's launch CTAs of
    both ranks (< 0: a cooperative grid)."""
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for

    c = g.chain_prefix
    mask, edges = g.edge_mask.clone(), g.edges.clone()
    mask[c::2] = False
    edges[c::2] = 0
    small = datasets.sphere(n_rings=6, poses_per_ring=10, seed=1)
    lib6.cg6_row_ctas.argtypes = [ctypes.c_longlong]
    for name, graph, huber, half, poses in (
            ("plain", g, -1.0, True, p0), ("huber", g, 1.0, True, p0),
            ("masked", g.replace(edge_mask=mask, edges=edges), 1.0, True, p0),
            ("chain_rank", g, 1.0, False, p0),
            ("small_chain_rank", from_dataset(small, device="cpu"), 1.0, False,
             torch.from_numpy(small["poses"]))):
        n = poses.shape[0]
        pk, K = g6.pack_graph6(graph, n), pcr_levels_for(n, None)
        cut = pk.El // 2 if half else 0
        shards = [cs6.make_shard6(pk, 0, cut, K, 1.0, huber),
                  cs6.make_shard6(pk, cut, pk.El, K, 0.0, huber)]
        runs = []
        for staged in (False, True):
            kerns = [cs6.CgStep6Kernel(sh) for sh in shards]
            runs.append([t.clone() for k in kerns
                         for t in (k.stage_a_staged if staged else k.stage_a)(poses)])
        out[f"k7a_{name}_bitwise"] = all(torch.equal(a, b) for a, b in zip(*runs))
        out[f"k7a_{name}_finite"] = all(bool(torch.isfinite(t).all()) for t in runs[0]) and \
            float(runs[0][0].abs().max()) > 0
        out[f"k7a_{name}_ctas"] = [lib6.cg6_row_ctas(max(sh.N, sh.c + sh.El)) for sh in shards]


def k7_persistent_checks(out, cs6, g6, g, p0):
    """K7b (gn_setup) and K7c (cg_step), one launch each, against
    gn_setup_staged and cg_step_staged on two ranks' shards of the sphere
    g at exact PCR (half the loop edges each, the chain on rank 0, the
    all-reduces summed here), bitwise: both ranks' Setups, and both ranks'
    whole carries after 1 and 26 passes. Cases: no Huber at lam 0, Huber at
    lam 1e-3, masked loop slots clipped onto node 0 (Huber, lam 1e-3), the
    chain alone (lam 0)."""
    from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for

    n, c, E = p0.shape[0], g.chain_prefix, g.num_edges
    K = pcr_levels_for(n, None)
    mask, edges = g.edge_mask.clone(), g.edges.clone()
    mask[c::2] = False
    edges[c::2] = 0
    for name, graph, huber, lam in (
            ("plain", g, -1.0, 0.0), ("huber_lam1e-3", g, 1.0, 1e-3),
            ("masked", g.replace(edge_mask=mask, edges=edges), 1.0, 1e-3),
            ("chain", g.replace(edge_mask=g.edge_mask & (torch.arange(E) < c)), -1.0, 0.0)):
        pk = g6.pack_graph6(graph, n)
        half = pk.El // 2
        runs = []
        for staged in (False, True):
            kerns = [cs6.CgStep6Kernel(cs6.make_shard6(pk, 0, half, K, 1.0, huber)),
                     cs6.CgStep6Kernel(cs6.make_shard6(pk, half, pk.El, K, 0.0, huber))]
            pays = [k.stage_a(p0)[0].clone() for k in kerns]
            sts = [(k.gn_setup_staged if staged else k.gn_setup)(pays[0] + pays[1], p0,
                                                                  torch.tensor([lam]))
                   for k in kerns]
            snaps = [[t.clone() for st in sts for t in st]]
            carries = [k.cg_state(sts[0].b) for k in kerns]
            for it in range(26):
                for k, cr in zip(kerns, carries):
                    (k.cg_step_staged if staged else k.cg_step)(k.Aij, cr)
                big = carries[0].big + carries[1].big
                for cr in carries:
                    cr.big.copy_(big)
                if it in (0, 25):
                    snaps.append([t.clone() for cr in carries for t in cr])
            runs.append(snaps)
        (sa, *ca), (sb, *cb) = runs
        out[f"k7b_{name}_bitwise"] = all(torch.equal(a, b) for a, b in zip(sa, sb))
        out[f"k7c_{name}_bitwise"] = all(
            torch.equal(a, b) for x, y in zip(ca, cb) for a, b in zip(x, y))
        out[f"k7c_{name}_finite"] = bool(torch.isfinite(ca[1][0]).all()) and \
            float(ca[1][0].abs().max()) > 0


def bits_equal(a, b) -> bool:
    """a and b bit for bit (NaNs included, which torch.equal calls unequal)."""
    if a.dtype == torch.float32:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def k5_persistent_checks(out, p6, g, p0):
    """K5 (Pcg6Kernel.solve, one launch of the wide kernel) against the
    staged gn6_factor + gn6_cg on the same problem, bitwise: at lam 0, and
    at lam 1e-3 with masked loop slots clipped onto node 0."""
    from graphslam_tpu_torch.factors.linearize import linearize
    from graphslam_tpu_torch.solver import normal_eq as ne

    n, c = p0.shape[0], g.chain_prefix
    mask, edges = g.edge_mask.clone(), g.edges.clone()
    mask[c::2] = False
    edges[c::2] = 0
    for name, graph, lam in (("k5", g, 0.0),
                             ("k5_lam1e-3_masked", g.replace(edge_mask=mask, edges=edges), 1e-3)):
        sysm = ne.build_blocks(linearize(p0, graph), graph, n)
        kern = p6.Pcg6Kernel(*p6._chain_and_loops(sysm, torch.tensor(lam), True, c, T=6), 25)
        a = kern.solve().clone()
        b = kern.staged().clone()
        out[f"{name}_bitwise"] = bool(torch.equal(a, b))
        out[f"{name}_finite"] = bool(torch.isfinite(a).all()) and float(a.abs().max()) > 0


def _scan_pair(ik):
    """Two simulated scans of the default world (300 beams in 320 points)
    at nearby poses: (src, src_mask, tgt, tgt_mask) and the initial guess."""
    from graphslam_tpu_torch.config import FrontendConfig
    from graphslam_tpu_torch.frontend.projection import beam_angles, scan_to_points
    from graphslam_tpu_torch.geometry import se2
    from graphslam_tpu_torch.sim import world

    fc = FrontendConfig(num_beams=300, max_points=320)
    angles = beam_angles(fc.num_beams, fc.fov_rad, device="cpu")
    wd = world.default_world("cpu")

    def scan(pose):
        r = world.raycast(wd, torch.tensor(pose), angles, fc.max_range)
        return scan_to_points(r, angles, fc.min_range, fc.max_range, fc.max_points)

    tgt_pose, src_pose = [-7.0, -5.0, 0.2], [-6.85, -4.9, 0.27]
    (sp, sm), (tp, tm) = scan(src_pose), scan(tgt_pose)
    init = se2.between(torch.tensor(tgt_pose), torch.tensor(src_pose)) + torch.tensor(
        [0.03, -0.03, 0.02])
    return (sp, sm, tp, tm), init


def k2_persistent_checks(out, ik):
    """K2 (icp_match and icp_iteration, one launch of k_icp_rounds) against
    the staged icp_match_staged / icp_iteration_staged, bitwise: delta, H,
    stats, |upd| and ctrl [done, rounds run] of the loop, H, g and stats of
    a round. Cases: a scan pair with early exit (it converges) and without
    (every round runs); the source scan on itself (done after round 1); a
    tolerance of 0 (never converges, every round runs); masked source
    points, invalid and duplicate targets (ties in d2); Q above the CTAs'
    shared-memory tile; one round on random points, with no valid target,
    with NaN points and with infinite points."""
    import numpy as np

    from graphslam_tpu_torch.frontend import icp

    lib = ik._lib()
    (sp, sm, tp, tm), init = _scan_pair(ik)
    out["k2_points"] = int(sp.shape[0])
    out["k2_ctas"] = lib.icp_ctas(sp.shape[0])
    out["k2_tile"] = lib.icp_loop_tile()

    def covs(pts, mask):
        return icp.surfel_covs(pts, mask, 4, 1e-3)

    def loop(name, src, smask, tgt, tmask, delta0, iterations, tol, early):
        runs = []
        for fn in ("icp_match", "icp_match_staged"):
            res, ctrl = ik._loop(fn, src, smask, tgt, tmask, covs(src, smask), covs(tgt, tmask),
                                 delta0, iterations, 1.0, 1e-6, tol, early)
            runs.append([t.clone() for t in res] + [ctrl.clone()])
        out[f"{name}_bitwise"] = all(bits_equal(a, b) for a, b in zip(*runs))
        out[f"{name}_finite"] = bool(torch.isfinite(runs[0][0]).all())
        out[f"{name}_ctrl"] = runs[0][4].tolist()

    loop("k2_pair_early", sp, sm, tp, tm, init, 16, 1e-5, True)
    loop("k2_pair_fixed", sp, sm, tp, tm, init, 16, 1e-5, False)
    loop("k2_self_round1", sp, sm, sp, sm, torch.zeros(3), 16, 1e-5, True)
    loop("k2_tol0_all_rounds", sp, sm, tp, tm, init, 12, 0.0, True)
    rng = np.random.default_rng(3)
    smask = sm & torch.from_numpy(rng.random(sm.shape[0]) < 0.8)
    tgt, tmask = tp.clone(), tm & torch.from_numpy(rng.random(tm.shape[0]) < 0.85)
    tgt[1::5] = tgt[0::5][: tgt[1::5].shape[0]]  # duplicates: ties in d2
    loop("k2_masked_ties", sp, smask, tgt, tmask, init, 16, 1e-5, True)

    # Q above one tile: random points around the scan pair's
    P, Q = 100, out["k2_tile"] + 164
    src = torch.from_numpy(rng.normal(size=(P, 2)).astype(np.float32))
    tgt = torch.from_numpy(rng.normal(size=(Q, 2)).astype(np.float32))
    tmask = torch.from_numpy(rng.random(Q) < 0.9)
    tgt[Q - 40:] = src[:40] + 0.01  # the nearest targets in the last tile
    loop("k2_tiles", src, torch.ones(P, dtype=torch.bool), tgt, tmask,
         torch.tensor([0.01, -0.02, 0.01]), 4, 1e-5, False)
    out["k2_tiles_q"] = Q

    def round_(name, args):
        a = [t.clone() for t in ik.fused_icp_iteration(*args, max_corr2=1.0, eps=1e-6)]
        b = [t.clone() for t in ik.fused_icp_iteration_staged(*args, max_corr2=1.0, eps=1e-6)]
        out[f"{name}_bitwise"] = all(bits_equal(x, y) for x, y in zip(a, b))

    f = np.float32
    P, Q = 200, 256
    A = (rng.normal(size=(Q, 2, 2)) * 0.3).astype(f)
    args = [torch.from_numpy(x) for x in (
        rng.normal(size=(P, 2)).astype(f), rng.normal(size=(P, 2)).astype(f),
        rng.random(P) < 0.9, rng.normal(size=(Q, 2)).astype(f), rng.random(Q) < 0.85,
        (np.einsum("qij,qkj->qik", A, A) + 0.1 * np.eye(2)).astype(f),
        (np.abs(rng.normal(size=(P, 3))) * np.array([1.0, 0.1, 1.0])).astype(f))]
    round_("k2_round", args)
    round_("k2_round_tiles", [args[0][:P], args[1], args[2], torch.cat([args[3]] * 7),
                              torch.cat([args[4]] * 7), torch.cat([args[5]] * 7), args[6]])
    no_valid = list(args)
    no_valid[4] = torch.zeros(Q, dtype=torch.bool)
    round_("k2_round_no_valid", no_valid)
    nan_pts = list(args)
    nan_pts[0] = args[0].clone()
    nan_pts[0][::7] = float("nan")
    round_("k2_round_nan_points", nan_pts)
    _, g, st = ik.fused_icp_iteration(*nan_pts, max_corr2=1.0, eps=1e-6)
    out["k2_round_nan_points_nan"] = bool(torch.isnan(g).all() and torch.isnan(st[3]))
    inf_pts = list(args)
    inf_pts[0] = args[0].clone()
    inf_pts[0][::11] = float("inf")  # +inf distances to every valid target
    round_("k2_round_inf_points", inf_pts)


def k8_persistent_checks(out, cc, ik):
    """K8 (nearest_neighbors: k_nn, a group of threads a source point)
    against nearest_neighbors_serial (one thread a point), bit for bit: idx,
    and d2 with NaNs by their bits. Cases: random points (P = 300, not a
    multiple of the groups a CTA), ties (coordinates on a half grid),
    duplicate targets, no valid target, 1700 targets (above the 1536 a CTA stages at once; the
    nearest in the last tile), NaN and infinite source points."""
    import numpy as np

    rng = np.random.default_rng(11)
    f = np.float32
    P, Q = 300, 256
    src = torch.from_numpy(rng.normal(size=(P, 2)).astype(f))
    tgt = torch.from_numpy(rng.normal(size=(Q, 2)).astype(f))
    valid = torch.from_numpy(rng.random(Q) < 0.85)
    ties_src, ties_tgt = torch.round(src * 2) / 2, torch.round(tgt * 2) / 2
    dup = tgt.clone()
    dup[1::3] = dup[0::3][: dup[1::3].shape[0]]
    Qt = 1700
    tile_tgt = torch.from_numpy(rng.normal(size=(Qt, 2)).astype(f))
    tile_tgt[Qt - 40:] = src[:40] + 0.01
    tile_valid = torch.from_numpy(rng.random(Qt) < 0.9)
    nan_src, inf_src = src.clone(), src.clone()
    nan_src[::7] = float("nan")
    nan_src[3::7, 1] = float("nan")
    inf_src[::11] = float("inf")
    inf_src[5::11, 0] = float("-inf")
    cases = {"random": (src, tgt, valid), "ties": (ties_src, ties_tgt, valid),
             "duplicates": (src, dup, valid),
             "no_valid": (src, tgt, torch.zeros(Q, dtype=torch.bool)),
             "tiles": (src, tile_tgt, tile_valid), "nan_points": (nan_src, tgt, valid),
             "inf_points": (inf_src, tgt, valid)}
    for name, args in cases.items():
        a = cc.nearest_neighbors(*args)
        b = cc.nearest_neighbors_serial(*args)
        out[f"k8_{name}_bitwise"] = all(bits_equal(x, y) for x, y in zip(a, b))
    ridx, _ = cc.nearest_neighbors_reference(*cases["ties"])
    out["k8_ties_twin_idx"] = bool(torch.equal(cc.nearest_neighbors(*cases["ties"])[0], ridx))
    idx, d2 = cc.nearest_neighbors(*cases["no_valid"])
    out["k8_no_valid_inf_at_0"] = bool((idx == 0).all() and torch.isinf(d2).all())
    out["k8_tiles_q"] = Qt
    out["k8_points"] = P


LM_ARGS = (1e-5, 10.0, 1e-10, 1e7, 1e-9, 1e-6)  # lam0, factor, min, max, abs_tol, rel_tol


def solve_persistent_checks(out, name, Kernel, p0, g, levels, twin_gn, twin_lm, pose_err):
    """K1 or K4 (Kernel.solve and lm_solve, each one cluster launch) against
    solve_staged and lm_solve_staged on fresh problems, bitwise: GN with
    warm start and a cg ramp (poses and x) and LM with Huber 1.0 (poses
    and stats); each also against its plain twin (errors printed)."""
    ramp = ((2, 25), (1, 12))
    runs = []
    for staged in (False, True):
        kern = Kernel(p0, g, -1.0, levels, cg_max=25)
        (kern.solve_staged if staged else kern.solve)(ramp, True)
        runs.append([kern.poses.clone(), kern.x.clone()])
    ref = twin_gn(p0, g, 3, 25, pcr_levels=levels, warm_start=True, cg_ramp=ramp)
    out[f"{name}_warm_ramp_bitwise"] = all(torch.equal(a, b) for a, b in zip(*runs))
    out[f"{name}_warm_ramp_finite"] = bool(torch.isfinite(runs[0][0]).all()) and not \
        torch.equal(runs[0][0], p0)
    out[f"{name}_warm_ramp_vs_twin"] = pose_err(runs[0][0], ref)
    runs = []
    for staged in (False, True):
        kern = Kernel(p0, g, 1.0, levels, cg_max=25, lm=True)
        (kern.lm_solve_staged if staged else kern.lm_solve)(3, 25, *LM_ARGS)
        runs.append([kern.poses.clone(), kern.stats.clone()])
    ref = twin_lm(p0, g, iterations=3, cg_iters=25, huber_delta=1.0, pcr_levels=levels)
    out[f"{name}_lm_huber_bitwise"] = all(torch.equal(a, b) for a, b in zip(*runs))
    out[f"{name}_lm_huber_finite"] = bool(torch.isfinite(runs[0][0]).all()) and \
        float(runs[0][1][2]) > 0
    out[f"{name}_lm_huber_vs_twin"] = pose_err(runs[0][0], ref[0])
    out[f"{name}_lm_stats"] = [[float(t) for t in runs[0][1]], [float(t) for t in ref[1:]]]


def pose_max(a, b) -> float:
    return float((a - b).abs().max())


def solve_refusal_checks(out, name, Kernel, p0, g):
    """Where the card cannot place the cluster, K1's or K4's solve and
    lm_solve raise; their staged sequences still run."""
    for mode, lm in (("", False), ("_lm", True)):
        for suffix, staged in (("", False), ("_staged", True)):
            kern = Kernel(p0, g, 1.0, None, cg_max=25, lm=lm)
            try:
                if lm:
                    (kern.lm_solve_staged if staged else kern.lm_solve)(1, 5, *LM_ARGS)
                else:
                    (kern.solve_staged if staged else kern.solve)(((1, 5),), False)
                out[f"{name}{mode}{suffix}_raised"] = None
            except RuntimeError as e:
                out[f"{name}{mode}{suffix}_raised"] = str(e)


def refusal_checks(out, pk, cs, g, p0):
    """Where the card cannot place the cluster, K3 and K6a-c raise; the
    staged sequences still run (nothing falls back to them)."""
    from graphslam_tpu_torch.factors.linearize import linearize
    from graphslam_tpu_torch.ops import gn_kernel as gk
    from graphslam_tpu_torch.solver import normal_eq as ne

    n = p0.shape[0]
    sysm = ne.build_blocks(linearize(p0, g), g, n)
    kern = pk.PcgKernel(*pk._chain_and_loops(sysm, torch.tensor(0.0), True, g.chain_prefix), 25)
    for name, fn in (("k3", kern.solve), ("k3_staged", kern.staged)):
        try:
            fn()
            out[f"{name}_raised"] = None
        except RuntimeError as e:
            out[f"{name}_raised"] = str(e)
    pack = gk.pack_graph(g, n)
    k6 = cs.CgStepKernel(cs.make_shard(pack, 0, pack.El, 4, 1.0, -1.0))
    pay, Aij = k6.stage_a_staged(p0)
    lam = torch.zeros(1)
    carry = k6.cg_state(k6.gn_setup_staged(pay, p0, lam).b)
    for name, fn in (("k6a", lambda: k6.stage_a(p0)),
                     ("k6a_staged", lambda: k6.stage_a_staged(p0)),
                     ("k6b", lambda: k6.gn_setup(pay, p0, lam)),
                     ("k6b_staged", lambda: k6.gn_setup_staged(pay, p0, lam)),
                     ("k6c", lambda: k6.cg_step(Aij, carry)),
                     ("k6c_staged", lambda: k6.cg_step_staged(Aij, carry))):
        try:
            fn()
            out[f"{name}_raised"] = None
        except RuntimeError as e:
            out[f"{name}_raised"] = str(e)


def k2_refusal_checks(out, ik):
    """Where the card cannot place the cluster, K2's icp_match and
    icp_iteration raise; their staged entries still run."""
    (sp, sm, tp, tm), init = _scan_pair(ik)
    from graphslam_tpu_torch.frontend import icp

    cs, ct = icp.surfel_covs(sp, sm, 4, 1e-3), icp.surfel_covs(tp, tm, 4, 1e-3)
    moved, jtheta = ik._round_inputs(sp, init)
    rargs = (moved, jtheta, sm, tp, tm, ct, ik.rotated_covs(ik._packed(cs), init[2]))
    for name, fn in (
            ("k2", lambda: ik.fused_icp_loop(sp, sm, tp, tm, cs, ct, init, 4, 1.0, 1e-6, 1e-5)),
            ("k2_staged", lambda: ik.fused_icp_loop_staged(sp, sm, tp, tm, cs, ct, init, 4, 1.0,
                                                           1e-6, 1e-5)),
            ("k2_round", lambda: ik.fused_icp_iteration(*rargs, max_corr2=1.0, eps=1e-6)),
            ("k2_round_staged", lambda: ik.fused_icp_iteration_staged(*rargs, max_corr2=1.0,
                                                                      eps=1e-6))):
        try:
            fn()
            out[f"{name}_raised"] = None
        except RuntimeError as e:
            out[f"{name}_raised"] = str(e)


def k5_refusal_checks(out, p6, g, p0):
    """Where the card cannot place the cluster, K5 raises; gn6_factor +
    gn6_cg still run."""
    from graphslam_tpu_torch.factors.linearize import linearize
    from graphslam_tpu_torch.solver import normal_eq as ne

    sysm = ne.build_blocks(linearize(p0, g), g, p0.shape[0])
    kern = p6.Pcg6Kernel(*p6._chain_and_loops(sysm, torch.tensor(0.0), True, g.chain_prefix,
                                              T=6), 25)
    for name, fn in (("k5", kern.solve), ("k5_staged", kern.staged)):
        try:
            fn()
            out[f"{name}_raised"] = None
        except RuntimeError as e:
            out[f"{name}_raised"] = str(e)


def k7_refusal_checks(out, cs6, g6, g, p0):
    """Where the card cannot place the cluster or the grid, K7a's stage_a,
    K7b's gn_setup and K7c's cg_step raise; their staged sequences still
    run."""
    from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for

    n = p0.shape[0]
    pk = g6.pack_graph6(g, n)
    kern = cs6.CgStep6Kernel(cs6.make_shard6(pk, 0, pk.El, pcr_levels_for(n, None), 1.0, -1.0))
    pay, Aij = kern.stage_a_staged(p0)
    lam = torch.zeros(1)
    calls = (("k7a", lambda: kern.stage_a(p0)),
             ("k7a_staged", lambda: kern.stage_a_staged(p0)),
             ("k7b", lambda: kern.gn_setup(pay, p0, lam)),
             ("k7b_staged", lambda: kern.gn_setup_staged(pay, p0, lam)),
             ("k7c", lambda: kern.cg_step(Aij, carry)),
             ("k7c_staged", lambda: kern.cg_step_staged(Aij, carry)))
    carry = kern.cg_state(kern.gn_setup_staged(pay, p0, lam).b)
    for name, fn in calls:
        try:
            fn()
            out[f"{name}_raised"] = None
        except RuntimeError as e:
            out[f"{name}_raised"] = str(e)


KERNELS = ("k3", "k6c", "k6ab", "k1", "k4", "k5", "k7a", "k7b", "k7c", "k2", "k8")


def main_persistent(ns, spheres, build_dir, max_cluster: int, unplaceable: bool = False,
                    kernels=KERNELS) -> None:
    """The persistent kernels against their staged sequences, bitwise: K3,
    K6a-c and K1 (GN and LM) on manhattan(n), K4 (GN and LM), K5, K7b and K7c
    on sphere(rings, per_ring); the sources they need built once, at once,
    for every size.
    Size i is ns[i] and spheres[i] (a list of one stands for every i); one
    JSON line a size. With unplaceable, the occupancy query places no
    cluster, and every persistent entry must raise instead while the staged
    sequences run."""
    need = {"k3": "gn_kernel", "k1": "gn_kernel", "k6c": "cg_step", "k6ab": "cg_step",
            "k4": "gn6_kernel",
            "k5": "gn6_kernel", "k7a": "cg_step6", "k7b": "cg_step6", "k7c": "cg_step6",
            "k2": "icp_kernel", "k8": "icp_kernel"}
    libs = build_all({name: (name, build_dir, ROOT) for name in sorted({need[k] for k in kernels})},
                     max_cluster, unplaceable)
    mods = load_ops(libs, ("gn_kernel", "pcg_kernel", "gn6_kernel", "pcg6_kernel",
                           "icp_kernel", "correspondence"))
    gk, pk, g6, p6, ik, cc = mods
    cs, cs6 = load_cg_step({k: libs[k] for k in ("cg_step", "cg_step6") if k in libs})[:2]
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.io import datasets

    if {"k2", "k8"} & set(kernels) and not unplaceable:
        # K2 and K8 have sizes of their own: one JSON line before the others
        out = {}
        if "k2" in kernels:
            k2_persistent_checks(out, ik)
        if "k8" in kernels:
            k8_persistent_checks(out, cc, ik)
        print(json.dumps(out), flush=True)
        kernels = [k for k in kernels if k not in ("k2", "k8")]
        if not kernels:
            return
    for i in range(max(len(ns), len(spheres))):
        n = ns[i if len(ns) > 1 else 0]
        rings, per_ring = spheres[i if len(spheres) > 1 else 0]
        data = datasets.manhattan(n_poses=n, loop_prob=0.25, seed=0)
        g = from_dataset(data, device="cpu")
        p0 = torch.from_numpy(data["poses"])
        nb = -(-n // 256)
        out = {"poses": n, "loop_edges": g.num_edges - g.chain_prefix,
               "ctas": min(nb, max_cluster or 16), "blocks": nb}
        if "k6ab" in kernels:  # K6a's and K6b's launch CTAs (< 0: a grid)
            lib_cg = ctypes.CDLL(str(libs["cg_step"]))
            lib_cg.cg_row_ctas.argtypes = [ctypes.c_longlong]
            out.update(k6a_ctas=lib_cg.cg_row_ctas(max(n, g.num_edges)),
                       k6b_ctas=lib_cg.cg_row_ctas(n))
        k7 = {"k7a", "k7b", "k7c"} & set(kernels)
        if {"k4", "k5"} & set(kernels) or k7:
            d6 = datasets.sphere(n_rings=rings, poses_per_ring=per_ring, seed=1)
            g_6 = from_dataset(d6, device="cpu")
            p_6 = torch.from_numpy(d6["poses"])
            n6 = p_6.shape[0]
            out["poses6"] = n6
            if "gn6_kernel" in libs:
                lib6 = ctypes.CDLL(str(libs["gn6_kernel"]))
                ctas = lib6.gn6_wide_ctas(n6)  # negative: a cooperative grid
                out.update(slots6=lib6.gn6_wide_slots(), ctas6=abs(ctas), grid6=ctas < 0)
            if k7:
                lib_cg6 = ctypes.CDLL(str(libs["cg_step6"]))
                ctas = lib_cg6.cg6_wide_ctas(n6)
                out.update(ctas7=abs(ctas), grid7=ctas < 0)
        if unplaceable:
            if {"k3", "k6c", "k6ab"} <= set(kernels):
                refusal_checks(out, pk, cs, g, p0)
            if "k1" in kernels:
                solve_refusal_checks(out, "k1", gk.GnKernel, p0, g)
            if "k4" in kernels:
                solve_refusal_checks(out, "k4", g6.Gn6Kernel, p_6, g_6)
            if "k5" in kernels:
                k5_refusal_checks(out, p6, g_6, p_6)
            if k7:
                k7_refusal_checks(out, cs6, g6, g_6, p_6)
            if "k2" in kernels:
                k2_refusal_checks(out, ik)
            print(json.dumps(out), flush=True)
            continue
        if "k3" in kernels:
            k3_persistent_checks(out, pk, g, p0)
        if "k6c" in kernels:
            k6c_persistent_checks(out, cs, gk.pack_graph(g, n), p0, 4)
        if "k6ab" in kernels:
            k6ab_persistent_checks(out, cs, gk.pack_graph(g, n), p0, 4)
        if "k1" in kernels:
            solve_persistent_checks(out, "k1", gk.GnKernel, p0, g, 4,
                                    gk.fused_gn_solve_reference, gk.fused_lm_solve_reference,
                                    wrapped_max)
        if "k4" in kernels:
            solve_persistent_checks(out, "k4", g6.Gn6Kernel, p_6, g_6, None,
                                    g6.fused_gn6_solve_reference, g6.fused_lm6_solve_reference,
                                    pose_max)
        if "k5" in kernels:
            k5_persistent_checks(out, p6, g_6, p_6)
        if "k7a" in kernels:
            k7a_persistent_checks(out, cs6, g6, g_6, p_6, lib_cg6)
        if {"k7b", "k7c"} & set(kernels):
            k7_persistent_checks(out, cs6, g6, g_6, p_6)
        print(json.dumps(out), flush=True)


class _StagedAliases:
    """A build from before the persistent K1/K4 (K6a/K6b, K7a-c), whose
    entries are the staged sequences: `<p>_solve_staged` and
    `<p>_lm_solve_staged` resolve to its `<p>_solve` and `<p>_lm_solve`
    (`cg_stage_a_staged` and `cg_gn_setup_staged` to `cg_stage_a` and
    `cg_gn_setup`; `cg6_stage_a_staged`, `cg6_gn_setup_staged` and
    `cg6_step_staged` to `cg6_stage_a`, `cg6_gn_setup` and `cg6_step`)."""

    def __init__(self, lib):
        self._lib = lib

    def __getattr__(self, name):
        if name.endswith("_staged") and not hasattr(self._lib, name):
            name = name[: -len("_staged")]
        return getattr(self._lib, name)


def _two_rank_k67(cs, make_shard, Kernel, pack, K, p0, staged=()):
    """Two ranks' K6/K7 stage A, setup and 26 CG passes with Huber (the
    entries named in staged, of "stage_a", "gn_setup" and "cg_step", as
    their staged sequences); every output of rank 0 (the all-reduces
    summed here)."""
    half = pack.El // 2
    kerns = [Kernel(make_shard(pack, 0, half, K, 1.0, 1.0)),
             Kernel(make_shard(pack, half, pack.El, K, 0.0, 1.0))]

    def entry(k, name):
        return getattr(k, f"{name}_staged" if name in staged else name)

    outs = [[t.clone() for t in entry(k, "stage_a")(p0)] for k in kerns]
    sts = [entry(k, "gn_setup")(outs[0][0] + outs[1][0], p0, torch.tensor([1e-3]))
           for k in kerns]
    carries = [k.cg_state(sts[0].b) for k in kerns]
    for _ in range(26):
        for k, c in zip(kerns, carries):
            entry(k, "cg_step")(k.Aij, c)
        big = carries[0].big + carries[1].big
        for c in carries:
            c.big.copy_(big)
    return [t for o in outs for t in o] + list(sts[0]) + list(carries[0])


def main_vs_tree(tree: Path, n: int, rings: int, per_ring: int, build_dir) -> None:
    """The SE(2) sources (gn_kernel.cu, cg_step.cu) and the SE(3) ones
    (gn6_kernel.cu, cg_step6.cu) of this checkout against those of another
    one (`tree`, e.g. `git archive` of the parent commit), both under the
    emulation: on manhattan(n) K1's GN (warm, cg ramp) and LM solves, K3
    and K6a-c (two ranks, 26 K6c passes, Huber; also as this checkout's
    staged sequences); on sphere(rings, per_ring) K4's GN and LM solves,
    K5 and K7a-c likewise (also as this checkout's staged sequences);
    every output held to torch.equal. K1 and K4 run both as
    this checkout's persistent entries and as its staged ones (an older
    tree's entries that this one redesigned are staged: _StagedAliases). Checks that a change of a shared header
    or of a launch shape leaves the outputs as they were."""
    base = Path(build_dir or ROOT / "graphslam_tpu_torch" / "build" / "emu")
    names = ("gn_kernel", "cg_step", "gn6_kernel", "cg_step6")
    paths = build_all({(side, name): (name, base / side, root)
                       for side, root in (("new", ROOT), ("old", Path(tree))) for name in names})
    libs = {key: ctypes.CDLL(str(lib)) for key, lib in paths.items()}
    for name in names:
        libs["old", name] = _StagedAliases(libs["old", name])
    gk, pk, g6, p6 = load_ops({name: paths["new", name] for name in names},
                              ("gn_kernel", "pcg_kernel", "gn6_kernel", "pcg6_kernel"))
    cs, cs6, _, _ = load_cg_step({name: paths["new", name] for name in names})
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.factors.linearize import linearize
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.ops import _build
    from graphslam_tpu_torch.ops.pcg_kernel import pcr_levels_for
    from graphslam_tpu_torch.solver import normal_eq as ne

    data = datasets.manhattan(n_poses=n, loop_prob=0.25, seed=0)
    g = from_dataset(data, device="cpu")
    p0 = torch.from_numpy(data["poses"])
    sysm = ne.build_blocks(linearize(p0, g), g, n)
    d6 = datasets.sphere(n_rings=rings, poses_per_ring=per_ring, seed=1)
    g_6 = from_dataset(d6, device="cpu")
    p_6 = torch.from_numpy(d6["poses"])
    n6 = p_6.shape[0]
    sys6 = ne.build_blocks(linearize(p_6, g_6), g_6, n6)
    ramp = ((2, 25), (1, 12))

    def solves(res, key, Kernel, poses, graph, levels):
        for suffix, staged in (("", False), ("_staged", True)):
            kern = Kernel(poses, graph, -1.0, levels, cg_max=25)
            res[f"{key}_gn{suffix}"] = [
                (kern.solve_staged if staged else kern.solve)(ramp, True).clone(), kern.x.clone()]
            kern = Kernel(poses, graph, 1.0, levels, cg_max=25, lm=True)
            stats = (kern.lm_solve_staged if staged else kern.lm_solve)(3, 25, *LM_ARGS)
            res[f"{key}_lm{suffix}"] = [kern.poses.clone(), stats.clone()]

    def run(side):
        _build.load = lambda name: libs[side, name]
        res = {}
        solves(res, "k1", gk.GnKernel, p0, g, 4)
        args = pk._chain_and_loops(sysm, torch.tensor(1e-3), True, g.chain_prefix)
        res["k3"] = [pk.PcgKernel(*args, 25).solve().clone()]
        for key, staged in (("k6", ()), ("k6_staged", ("stage_a", "gn_setup", "cg_step"))):
            res[key] = _two_rank_k67(cs, cs.make_shard, cs.CgStepKernel, gk.pack_graph(g, n), 4,
                                     p0, staged)
        solves(res, "k4", g6.Gn6Kernel, p_6, g_6, None)
        args = p6._chain_and_loops(sys6, torch.tensor(1e-3), True, g_6.chain_prefix, T=6)
        kern5 = p6.Pcg6Kernel(*args, 25)
        res["k5"] = [kern5.solve().clone(), kern5.staged().clone()]
        for key, staged in (("k7", ()), ("k7_staged", ("stage_a", "gn_setup", "cg_step"))):
            res[key] = _two_rank_k67(cs6, cs6.make_shard6, cs6.CgStep6Kernel,
                                     g6.pack_graph6(g_6, n6), pcr_levels_for(n6, None), p_6,
                                     staged)
        return res

    new, old = run("new"), run("old")
    out = {"poses": n, "poses6": n6, "tree": str(tree)}
    for key in new:
        out[f"{key}_bitwise"] = all(torch.equal(a, b) for a, b in zip(new[key], old[key]))
    print(json.dumps(out))


def wrapped_max(a, b) -> float:
    d = (a - b).double()
    d[:, 2] = torch.remainder(d[:, 2] + math.pi, 2 * math.pi) - math.pi
    return float(d.abs().max())


def main_se3(rings: int, per_ring: int) -> None:
    _, _, g6, p6 = load_ops({"gn6_kernel": build("gn6_kernel")},
                            ("gn_kernel", "pcg_kernel", "gn6_kernel", "pcg6_kernel"))
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.factors.linearize import linearize
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.solver import normal_eq as ne

    data = datasets.sphere(n_rings=rings, poses_per_ring=per_ring, seed=1)
    g = from_dataset(data, device="cpu")
    p0 = torch.from_numpy(data["poses"])
    n = p0.shape[0]
    out = {"poses": n, "loop_edges": g.num_edges - g.chain_prefix}

    def rel(a, b):
        return float((a - b).abs().max() / b.abs().max())

    kern = g6.Gn6Kernel(p0, g, -1.0, None, cg_max=25)
    kern.system()
    sysm = g6.system_reference6(p0, kern.pk)
    out["D"], out["b"], out["U"] = rel(kern.D, sysm.D), rel(kern.b, sysm.b), rel(kern.U, sysm.U)
    kern.factor()
    factor = g6.pcr_factor_reference6(sysm.D, sysm.U, kern.K)
    v = torch.randn((n, 6), generator=torch.Generator().manual_seed(0))
    out["pcr_apply"] = rel(kern.precond(v), g6.gk.pcr_apply_reference(*factor, v))
    kern.cg(25)
    out["cg"] = rel(kern.x, g6.gk.cg_reference(sysm, kern.pk, factor, 25))

    E, c = g.num_edges, g.chain_prefix
    mask = g.edge_mask.clone()
    mask[E - 1] = False
    mask[c - 2] = False
    chain = g.replace(edge_mask=g.edge_mask & (torch.arange(E) < c))
    for name, gg, kw in (("gn_pcr4", g, dict(pcr_levels=4)), ("gn_exact", g, {}),
                         ("gn_chain", chain, {}), ("gn_masked", g.replace(edge_mask=mask), {}),
                         ("gn_warm_ramp", g, dict(warm_start=True, cg_ramp=((2, 25), (1, 12))))):
        kern = g6.Gn6Kernel(p0, gg, -1.0, kw.get("pcr_levels"), cg_max=25)
        res = kern.solve(g6.gk._phases(3, 25, kw.get("cg_ramp")), kw.get("warm_start", False))
        ref = g6.fused_gn6_solve_reference(p0, gg, 3, 25, **kw)
        out[name] = float((res - ref).abs().max())
    kern = g6.Gn6Kernel(p0, g, 1.0, None, cg_max=25, lm=True)
    out["cost_rel"] = rel(kern.chi2(p0)[0], g6.chi2_reference6(p0, kern.pk, 1.0))
    stats = kern.lm_solve(3, 25, 1e-5, 10.0, 1e-10, 1e7, 1e-9, 1e-6).tolist()
    ref = g6.fused_lm6_solve_reference(p0, g, iterations=3, cg_iters=25, huber_delta=1.0)
    out["lm"] = {"poses": float((kern.poses - ref[0]).abs().max()), "stats": stats,
                 "twin_stats": [float(t) for t in ref[1:]]}
    sysm = ne.build_blocks(linearize(p0, g), g, n)
    for lam in (0.0, 1e-3):
        args = p6._chain_and_loops(sysm, torch.tensor(lam), True, c, T=6)
        x = p6.Pcg6Kernel(*args, 25).solve()
        xr = p6.fused_pcg6_solve_reference(sysm, torch.tensor(lam), 25, True, c)
        out[f"k5_lam{lam}"] = rel(x, xr)
    print(json.dumps(out))


def _ints(text: str):
    """[int, ...] of "a,b,..."; --poses, --rings and --per-ring take lists
    in --persistent mode, one value elsewhere."""
    return [int(t) for t in str(text).split(",")]


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", default="260")
    ap.add_argument("--se3", action="store_true")
    ap.add_argument("--dist", action="store_true")
    ap.add_argument("--dist6", action="store_true")
    ap.add_argument("--persistent", action="store_true")
    ap.add_argument("--max-cluster", type=int, default=0)
    ap.add_argument("--unplaceable", action="store_true")
    ap.add_argument("--kernels", default=",".join(KERNELS))
    ap.add_argument("--build-dir", type=Path, default=None)
    ap.add_argument("--vs-tree", type=Path, default=None)
    ap.add_argument("--rings", default="6")
    ap.add_argument("--per-ring", default="8")
    args = ap.parse_args()
    if not args.persistent:
        args.poses, args.rings, args.per_ring = (int(args.poses), int(args.rings),
                                                 int(args.per_ring))
    if args.se3:
        return main_se3(args.rings, args.per_ring)
    if args.dist:
        return main_dist(args.poses)
    if args.dist6:
        return main_dist6(args.rings, args.per_ring)
    if args.vs_tree:
        return main_vs_tree(args.vs_tree, args.poses, args.rings, args.per_ring,
                            args.build_dir)
    if args.persistent:
        rings, per_ring = _ints(args.rings), _ints(args.per_ring)
        if len(rings) != len(per_ring):
            raise SystemExit("--rings and --per-ring need as many values")
        return main_persistent(_ints(args.poses), list(zip(rings, per_ring)), args.build_dir,
                               args.max_cluster, args.unplaceable, args.kernels.split(","))
    n = args.poses
    gk, pk = load_ops({"gn_kernel": build()})
    from graphslam_tpu_torch.factors import from_dataset
    from graphslam_tpu_torch.factors.linearize import linearize
    from graphslam_tpu_torch.io import datasets
    from graphslam_tpu_torch.solver import normal_eq as ne

    data = datasets.manhattan(n_poses=n, loop_prob=0.25, seed=0)
    g = from_dataset(data, device="cpu")
    p0 = torch.from_numpy(data["poses"])
    out = {"poses": n, "loop_edges": g.num_edges - g.chain_prefix}

    kern = gk.GnKernel(p0, g, -1.0, 4, cg_max=25)
    gn = kern.solve(((5, 25),), False)
    out["gn_pcr4"] = wrapped_max(gn, gk.fused_gn_solve_reference(p0, g, 5, 25, pcr_levels=4))
    for levels in (4, None):
        kern = gk.GnKernel(p0, g, 1.0, levels, cg_max=25, lm=True)
        cost = float((kern.chi2(p0)[0] - gk.chi2_reference(p0, kern.pk, 1.0)).abs())
        stats = kern.lm_solve(5, 25, 1e-5, 10.0, 1e-10, 1e7, 1e-9, 1e-6).tolist()
        ref = gk.fused_lm_solve_reference(p0, g, iterations=5, cg_iters=25, huber_delta=1.0,
                                          pcr_levels=levels)
        out[f"lm_pcr{levels}"] = {"poses": wrapped_max(kern.poses, ref[0]), "cost_abs": cost,
                                  "stats": stats, "twin_stats": [float(t) for t in ref[1:]]}

    def k3(graph, lam):
        sysm = ne.build_blocks(linearize(p0, graph), graph, n)
        args = pk._chain_and_loops(sysm, torch.tensor(lam), True, graph.chain_prefix)
        x = pk.PcgKernel(*args, 25).solve()
        xr = pk.fused_pcg_solve_reference(sysm, torch.tensor(lam), 25, True, graph.chain_prefix)
        return float((x - xr).abs().max() / xr.abs().max())

    out["k3_lam0"], out["k3_lam1e-3"] = k3(g, 0.0), k3(g, 1e-3)
    mask, edges, c = g.edge_mask.clone(), g.edges.clone(), g.chain_prefix
    mask[c::2] = False
    edges[c::2] = 0  # masked slots clipped onto node 0, as in the online graph
    out["k3_masked"] = k3(g.replace(edge_mask=mask, edges=edges), 0.0)
    k3_persistent_checks(out, pk, g, p0)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
