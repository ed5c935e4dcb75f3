// The persistent-stage routine shared by the SE(2) kernels (se2_blocks.cuh:
// K1, K3, K6a-c) and the SE(3) kernels (se3_blocks.cuh: K4): the row block
// of kThreads rows, the deterministic block reductions, and ONE launch on a
// thread-block cluster (or a cooperative grid) that runs a whole sequence
// of row stages with a barrier where a staged sequence has a kernel
// boundary; pass_shape's rule for the launch.
// Included inside no namespace; everything here has internal linkage, one
// copy per library.

#pragma once

#include <mutex>
#include <vector>

#include <cooperative_groups.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = 1e-30f;

__host__ __device__ inline int n_blocks(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// Deterministic reductions: a fixed shared-memory tree per block, then every
// block sums the per-block partials in index order.
// ---------------------------------------------------------------------------

// The block sum of val over the kThreads threads into part[blk], blk the
// index of the 256-row block the threads cover (blockIdx.x in a staged
// launch; one of the blocks a CTA walks in a persistent one).
__device__ void block_sum_to(float val, float* part, int blk) {
  __shared__ float s[kThreads];
  const int t = threadIdx.x;
  s[t] = val;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) s[t] += s[t + stride];
    __syncthreads();
  }
  if (t == 0) part[blk] = s[0];
}

__device__ float sum_partials(const float* part, int n) {
  __shared__ float total;
  if (threadIdx.x == 0) {
    float acc = 0.f;
    for (int i = 0; i < n; ++i) acc += part[i];
    total = acc;
  }
  __syncthreads();
  return total;
}

// ---------------------------------------------------------------------------
// Persistent stages on one thread-block cluster
// ---------------------------------------------------------------------------
//
// A staged sequence (one launch per stage, n_blocks(N) blocks of kThreads
// threads, thread t of block b on row b * kThreads + t) runs as ONE launch
// of C = cluster_ctas(N) CTAs that form one cluster. CTA c walks the
// 256-row blocks c, c + C, c + 2C, ... of every stage and handles each row
// as the staged kernel does; a cluster barrier stands where the staged
// sequence has a kernel boundary. Its release/acquire at cluster scope
// makes one stage's global writes (vectors, block partials, scalars)
// visible to every CTA of the next; they are read with plain loads, never
// through __ldg or const __restrict__. Each 256-row block keeps its own
// shared-memory tree and its own index in the partials, and every CTA sums
// the partials in block order, so the results are bitwise those of the
// staged launches. Every thread of a CTA walks the same number of blocks
// and reaches every __syncthreads and every cluster barrier; rows past N
// compute nothing.
//
// One cluster holds at most 16 CTAs (the non-portable size), so it spans at
// most 16 of the H100's 132 SMs: width is traded for a barrier in hardware.
// At N = 3500 a stage touches ~0.3 MB, all of it in the 50 MB L2, so the
// stage's latency, not bandwidth, is what a launch boundary used to cost.

#ifndef PERSISTENT_MAX_CLUSTER
#define PERSISTENT_MAX_CLUSTER 16
#endif
constexpr int kMaxClusterCtas = PERSISTENT_MAX_CLUSTER;

// CTAs of the persistent launch over N rows: one per 256-row block, at most
// kMaxClusterCtas.
inline int cluster_ctas(long long N) {
  const int nb = n_blocks(N);
  return nb < 1 ? 1 : nb < kMaxClusterCtas ? nb : kMaxClusterCtas;
}

__device__ __forceinline__ void cluster_sync() { cooperative_groups::this_cluster().sync(); }

// The barrier between two stages of a kernel that launch_persistent may
// start either way: the cluster's where the grid is one cluster, else the
// cooperative grid's.
__device__ __forceinline__ void stage_sync() {
  if (cooperative_groups::this_cluster().num_blocks() == gridDim.x) cluster_sync();
  else cooperative_groups::this_grid().sync();
}

// f(n) for every row n < N of this CTA's blocks.
template <typename F>
__device__ __forceinline__ void for_rows(int N, F f) {
  const int nb = n_blocks(N);
  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    const int n = blk * kThreads + threadIdx.x;
    if (n < N) f(n);
  }
}

// f(i) for every i < M, one thread each over the whole launch: a stage
// whose rows share no reduction, so that any CTA width and count gives the
// same values.
template <typename F>
__device__ __forceinline__ void for_flat(long long M, F f) {
  const long long stride = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < M; i += stride)
    f((int)i);
}

// f(n) for every row n < N of this CTA's blocks; its values (0 past N)
// summed per 256-row block into part[blk].
template <typename F>
__device__ __forceinline__ void for_rows_sum(int N, float* part, F f) {
  const int nb = n_blocks(N);
  for (int blk = blockIdx.x; blk < nb; blk += gridDim.x) {
    const int n = blk * kThreads + threadIdx.x;
    block_sum_to(n < N ? f(n) : 0.f, part, blk);
  }
}

// The phases ((iterations, cg iterations), ...) of a GN solve, by value in
// a persistent kernel's parameters.
constexpr int kMaxPhases = 16;
struct Phases {
  int n;
  int iters[kMaxPhases];
  int cg[kMaxPhases];
};

// Phases from the C entries' arrays; false where there are more than
// kMaxPhases or a count is negative or above cg_max.
inline bool make_phases(int n_phases, const int* phase_iters, const int* phase_cg, int cg_max,
                        Phases& ph) {
  if (n_phases < 0 || n_phases > kMaxPhases) return false;
  ph = Phases{};
  ph.n = n_phases;
  for (int f = 0; f < n_phases; ++f) {
    if (phase_cg[f] < 0 || phase_cg[f] > cg_max || phase_iters[f] < 0) return false;
    ph.iters[f] = phase_iters[f];
    ph.cg[f] = phase_cg[f];
  }
  return true;
}

// The shape of a persistent launch: `ctas` CTAs as one cluster, or as a
// cooperative grid (each CTA its own cluster; stage_sync then takes the
// grid barrier).
struct Shape {
  int ctas;
  bool cooperative;
};

// The CTAs of `kernel` at `threads` threads that the card holds at once
// (its occupancy on one SM times the SMs), kept per kernel, device and
// width after the first query.
template <typename... KArgs>
cudaError_t coresident_ctas(void (*kernel)(KArgs...), int threads, int& out) {
  struct Known { const void* fn; int dev, threads, ctas; };
  static std::mutex mu;
  static std::vector<Known> known;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  std::lock_guard<std::mutex> lock(mu);
  for (const Known& k : known)
    if (k.fn == (const void*)kernel && k.dev == dev && k.threads == threads) {
      out = k.ctas;
      return cudaSuccess;
    }
  int per_sm = 0, sms = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads, 0);
  if (err != cudaSuccess) return err;
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return err;
  out = per_sm * sms;
  known.push_back(Known{(const void*)kernel, dev, threads, out});
  return cudaSuccess;
}

// Launches kernel(args...) on stream s in the shape sh, CTAs of `threads`
// threads: cudaLaunchKernelEx with the cluster dimension (above 8 CTAs the
// non-portable size is allowed first) or the cooperative attribute.
// Returns the CUDA error of the attribute, of the occupancy query or of the
// launch, and cudaErrorLaunchOutOfResources where the card cannot place
// such a cluster (cudaOccupancyMaxActiveClusters < 1) or holds fewer CTAs
// at once than the grid has. There is no other launch shape to fall back
// to. The attribute and the cluster occupancy answer are kept per kernel,
// device and shape after their first success.
template <typename... KArgs, typename... Args>
cudaError_t launch_persistent(void (*kernel)(KArgs...), Shape sh, int threads, cudaStream_t s,
                              Args... args) {
  struct Placed { const void* fn; int dev, ctas, threads; };
  static std::mutex mu;
  static std::vector<Placed> placed;
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  cudaLaunchAttribute attr[1];
  if (sh.cooperative) {
    attr[0].id = cudaLaunchAttributeCooperative;
    attr[0].val.cooperative = 1;
  } else {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = sh.ctas;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(sh.ctas, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = s;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  if (sh.cooperative) {
    int cap = 0;
    err = coresident_ctas(kernel, threads, cap);
    if (err != cudaSuccess) return err;
    if (cap < sh.ctas) return cudaErrorLaunchOutOfResources;
  } else {
    const Placed key{(const void*)kernel, dev, sh.ctas, threads};
    std::lock_guard<std::mutex> lock(mu);
    bool known = false;
    for (const Placed& q : placed)
      known |= q.fn == key.fn && q.dev == dev && q.ctas == sh.ctas && q.threads == threads;
    if (!known) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
      if (err != cudaSuccess) return err;
      int clusters = 0;
      err = cudaOccupancyMaxActiveClusters(&clusters, kernel, &cfg);
      if (err != cudaSuccess) return err;
      if (clusters < 1) return cudaErrorLaunchOutOfResources;
      placed.push_back(key);
    }
  }
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return err;
  return cudaGetLastError();
}

// The shape of a persistent launch of `kernel` (CTAs of `threads`) whose
// stages take `per_cta` rows a CTA at once, for one pass over N rows
// (ceil(N / per_cta) CTAs): one cluster where that is at most
// kMaxClusterCtas CTAs, else a cooperative grid of as many CTAs, at most
// the CTAs of `kernel` the card holds at once (they then walk several
// passes). One pass measured faster than a 16-CTA cluster walking several
// (K4, K6a, K6b, K7b, K7c: PERF.md).
template <typename... KArgs>
cudaError_t pass_shape(void (*kernel)(KArgs...), int threads, int per_cta, long long N,
                       Shape& sh) {
  const long long pass = (N + per_cta - 1) / per_cta;
  const int want = pass < 1 ? 1 : pass > (1 << 30) ? (1 << 30) : (int)pass;
  if (want <= kMaxClusterCtas) {
    sh = Shape{want, false};
    return cudaSuccess;
  }
  int cap = 0;
  const cudaError_t err = coresident_ctas(kernel, threads, cap);
  if (err != cudaSuccess) return err;
  if (cap < 1) return cudaErrorLaunchOutOfResources;
  sh = Shape{want < cap ? want : cap, true};
  return cudaSuccess;
}

// launch_persistent over N rows: one cluster of cluster_ctas(N) CTAs of
// kThreads.
template <typename... KArgs, typename... Args>
cudaError_t launch_cluster(void (*kernel)(KArgs...), long long N, cudaStream_t s,
                           Args... args) {
  return launch_persistent(kernel, Shape{cluster_ctas(N), false}, kThreads, s, args...);
}

}  // namespace
