#!/usr/bin/env python3
"""Rehearse csrc/gn_kernel.cu on the CPU, without a GPU or nvcc.

Usage:  python scripts/emulate_gn_kernel.py [--poses N]

Rewrites every `k<<<grid, block, 0, s>>>(` launch of the CUDA source into a
call of a C++ emulation (blocks in turn, the threads of a block as
std::threads meeting at a std::barrier for __syncthreads), compiles it with
g++ into graphslam_tpu_torch/build/emu/, loads it in place of the nvcc
build and drives the port's own wrappers on CPU tensors: K1's GN and LM
modes (GnKernel) and K3 (PcgKernel) on manhattan(N), each against its plain
torch twin. Prints one JSON line of max errors (poses wrapped, K3 relative
to the largest entry) and the LM stats of kernel and twin. Slow (a thread
per emulated CUDA thread): a minute or two at N = 260.
"""

import argparse
import ctypes
import json
import math
import re
import subprocess
import sys
import types
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

HEADER = r"""#pragma once
#include <cmath>
#include <cstring>
#include <thread>
#include <vector>
#include <barrier>
#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
struct dim3 { unsigned x = 1, y = 1, z = 1; };
inline thread_local dim3 threadIdx, blockIdx, blockDim;
inline thread_local std::barrier<>* emu_bar = nullptr;
inline void __syncthreads() { emu_bar->arrive_and_wait(); }
typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
inline const char* cudaGetErrorString(cudaError_t) { return "emu"; }
inline cudaError_t cudaMemsetAsync(void* p, int v, size_t n, cudaStream_t) {
  std::memset(p, v, n); return cudaSuccess; }
template <typename K, typename... A>
void emu_launch(int grid, int block, K kernel, A... args) {
  for (int b = 0; b < grid; ++b) {
    std::barrier<> bar(block);
    std::vector<std::thread> ts;
    for (int t = 0; t < block; ++t)
      ts.emplace_back([&, t] { threadIdx.x = t; blockIdx.x = b;
                               blockDim.x = block; emu_bar = &bar; kernel(args...); });
    for (auto& th : ts) th.join();
  }
}
"""


def build() -> Path:
    out = ROOT / "graphslam_tpu_torch" / "build" / "emu"
    out.mkdir(parents=True, exist_ok=True)
    (out / "cuda_runtime.h").write_text(HEADER)
    src = (ROOT / "graphslam_tpu_torch" / "csrc" / "gn_kernel.cu").read_text()
    src = re.sub(r"(\w+)<<<([^,]+),\s*([^,]+),\s*0,\s*s>>>\(", r"emu_launch(\2, \3, \1, ", src)
    (out / "gn_kernel_emu.cpp").write_text(src)
    lib = out / "libgn_kernel_emu.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-shared", "-fPIC", f"-I{out}", "-o", str(lib),
                    str(out / "gn_kernel_emu.cpp")], check=True)
    return lib


def load_ops(lib: Path):
    """The port's ops/gn_kernel.py and ops/pcg_kernel.py, with the emulated
    library in place of the nvcc build and the CUDA device checks dropped."""
    import graphslam_tpu_torch.ops as ops_pkg
    from graphslam_tpu_torch.ops import _build

    _build.load = lambda name: ctypes.CDLL(str(lib))
    torch.cuda.current_stream = lambda dev=None: types.SimpleNamespace(cuda_stream=0)
    mods = []
    for name in ("gn_kernel", "pcg_kernel"):
        path = ROOT / "graphslam_tpu_torch" / "ops" / f"{name}.py"
        mod = types.ModuleType(f"graphslam_tpu_torch.ops.{name}")
        mod.__file__ = str(path)
        sys.modules[mod.__name__] = mod
        setattr(ops_pkg, name, mod)
        code = path.read_text().replace('.type != "cuda"', '.type == "never"')
        exec(compile(code, str(path), "exec"), mod.__dict__)
        mods.append(mod)
    return mods


def wrapped_max(a, b) -> float:
    d = (a - b).double()
    d[:, 2] = torch.remainder(d[:, 2] + math.pi, 2 * math.pi) - math.pi
    return float(d.abs().max())


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--poses", type=int, default=260)
    n = ap.parse_args().poses
    gk, pk = load_ops(build())
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
    print(json.dumps(out))


if __name__ == "__main__":
    main()
