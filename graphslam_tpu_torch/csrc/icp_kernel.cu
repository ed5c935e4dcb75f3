// GICP IRLS iteration (K2) and nearest valid target (K8) for Hopper (sm_90a):
// the CUDA port of the Pallas kernels graphslam_tpu/ops/icp_kernel.py::_kernel
// and graphslam_tpu/ops/correspondence.py::_nn_kernel.
//
// One thread per source point scans every target, staged through shared
// memory in tiles of kTile points, for the nearest valid one:
//
//   * exact coordinate differences, d2 = dx*dx + dy*dy with each product and
//     the sum rounded on its own (no FMA contraction, never |a|^2+|b|^2-2ab),
//     so the distances are bit for bit those of the plain torch twin;
//   * argmin semantics: the first index of the minimum; invalid targets read
//     `big` (3.4e38 for K2 as icp_kernel.py:45, +inf for K8 as
//     correspondence.py:47), so with no valid target the index is 0.
//
// K2 then reads the matched target's surfel covariance, inverts the 2x2
// combined covariance (|det| < 1e-20 clamped) and reduces the 13 sums
// [H upper 6, g 3, sum_d2_all, sum_d2_gated, n_match, sum_mahal] without
// atomics: a fixed-order tree inside each block, then one block sums the
// block partials in block order. Two runs give bitwise equal results.
//
// The IRLS loop of frontend/icp.py::gicp_match stays on the device:
// icp_match enqueues `iterations` rounds of k_icp_iter (partials, with the
// moved points, dR/dtheta and rotated source covariances computed from the
// current delta) and k_icp_finish (one thread: sum, H += 1e-6 I, 3x3 solve
// with partial pivoting, delta update with the angle wrapped, stats). With
// early exit, k_icp_finish raises a device flag once |upd| < tol, and both
// kernels of every later round return at once, as jax.lax.while_loop stops:
// the first round always runs, and the stats are the last executed round's.
//
// What bounds it on an H100 at P = Q = 1152: one round is 1.3M distance
// evaluations (~7 MFLOP, ~0.1 us at the card's float32 peak) on ~60 KB of
// inputs, so launch latency (two launches a round) and the 18 blocks that
// leave most SMs idle bound it, not bytes or FLOPs. Warp-level argmin, more
// blocks per point set and a persistent match kernel are later work.
//
// Plain C interface for ctypes: device pointers in a struct, launches on
// problem->stream, each function returns cudaGetLastError() (0 = success).

#include <cuda_runtime.h>
#include <math.h>

extern "C" {

struct IcpProblem {
  const float* pts;                // (P, 2) loop: source points; one round: moved points
  const float* jtheta;             // (P, 2) one round only: dR/dtheta @ source point
  const float* cov;                // (P, 3) loop: source surfel covs [a, b, d];
                                   //        one round: rotated [c11, c12, c22]
  const unsigned char* src_mask;   // (P,) bool
  const float* tgt;                // (Q, 2)
  const unsigned char* tgt_valid;  // (Q,) bool
  const float* ct;                 // (Q, 3) target surfel covs [c11, c12, c22]
  float* partials;                 // (n_blocks, kLanes)
  float* delta;                    // (3,) loop: in/out estimate
  float* out;                      // (kLanes,) see icp_iteration / icp_match
  int* ctrl;                       // (2,) loop: [done, rounds run]
  void* stream;                    // cudaStream_t
  int P, Q;
  float max_corr2, eps, tol;
};

}  // extern "C"

namespace {

constexpr int kBlock = 64;     // source points per block
constexpr int kTile = 2048;    // targets staged in shared memory at a time
constexpr int kLanes = 16;     // 13 sums, padded
constexpr int kSums = 13;
constexpr float kBigIcp = 3.4e38f;

inline int n_blocks(int n) { return (n + kBlock - 1) / kBlock; }

struct Nearest {
  float d2;
  int idx;
};

// Nearest target of (mx, my) among the Q targets, invalid ones reading `big`.
// Every thread of the block calls it (it synchronises); a thread past the
// last point passes any coordinates and ignores the result.
__device__ Nearest block_nearest(float mx, float my, const float* tgt,
                                 const unsigned char* valid, int Q, float big) {
  __shared__ float sx[kTile];
  __shared__ float sy[kTile];
  __shared__ unsigned char sv[kTile];
  Nearest best{big, 0};
  for (int base = 0; base < Q; base += kTile) {
    const int n = Q - base < kTile ? Q - base : kTile;
    __syncthreads();  // the previous tile is consumed
    for (int j = threadIdx.x; j < n; j += blockDim.x) {
      sx[j] = tgt[2 * (base + j)];
      sy[j] = tgt[2 * (base + j) + 1];
      sv[j] = valid[base + j];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      const float dx = mx - sx[j];
      const float dy = my - sy[j];
      const float d2 = sv[j] ? __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)) : big;
      if ((base == 0 && j == 0) || d2 < best.d2) {
        best.d2 = d2;
        best.idx = base + j;
      }
    }
  }
  return best;
}

// Sum v[k] over the block's threads in a fixed tree order; thread 0 writes
// the block's partials.
__device__ void block_reduce_store(float (&v)[kSums], float* partials) {
  __shared__ float red[kSums][kBlock];
  const int t = threadIdx.x;
  for (int k = 0; k < kSums; ++k) red[k][t] = v[k];
  __syncthreads();
  for (int s = kBlock / 2; s > 0; s >>= 1) {
    if (t < s)
      for (int k = 0; k < kSums; ++k) red[k][t] += red[k][t + s];
    __syncthreads();
  }
  if (t == 0)
    for (int k = 0; k < kLanes; ++k)
      partials[blockIdx.x * kLanes + k] = k < kSums ? red[k][0] : 0.0f;
}

// One IRLS round's block partials (icp_kernel.py:38-101). kLoop: the moved
// points, jtheta and rotated source covariances come from p.delta.
template <bool kLoop>
__global__ void k_icp_iter(IcpProblem p, int early_exit) {
  if (kLoop && early_exit && p.ctrl[0]) return;  // uniform over the grid
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < p.P;
  float mx = 0.f, my = 0.f, jx = 0.f, jy = 0.f, s11 = 0.f, s12 = 0.f, s22 = 0.f;
  if (live) {
    const float x = p.pts[2 * i], y = p.pts[2 * i + 1];
    const float a = p.cov[3 * i], b = p.cov[3 * i + 1], d = p.cov[3 * i + 2];
    if (kLoop) {
      const float c = cosf(p.delta[2]), s = sinf(p.delta[2]);
      mx = c * x - s * y + p.delta[0];
      my = s * x + c * y + p.delta[1];
      jx = -s * x - c * y;
      jy = c * x - s * y;
      s11 = c * c * a - 2.f * c * s * b + s * s * d;
      s12 = c * s * (a - d) + (c * c - s * s) * b;
      s22 = s * s * a + 2.f * c * s * b + c * c * d;
    } else {
      mx = x;
      my = y;
      jx = p.jtheta[2 * i];
      jy = p.jtheta[2 * i + 1];
      s11 = a;
      s12 = b;
      s22 = d;
    }
  }
  const Nearest nn = block_nearest(mx, my, p.tgt, p.tgt_valid, p.Q, kBigIcp);

  float v[kSums];
  for (int k = 0; k < kSums; ++k) v[k] = 0.f;
  if (live) {
    const bool sm = p.src_mask[i] != 0;
    const bool w = nn.d2 < kBigIcp * 0.5f && sm && nn.d2 <= p.max_corr2;
    const float wf = w ? 1.f : 0.f;
    const float wall = sm ? 1.f : 0.f;
    const float qx = p.tgt[2 * nn.idx], qy = p.tgt[2 * nn.idx + 1];
    const float c11 = p.ct[3 * nn.idx] + s11 + p.eps;
    const float c12 = p.ct[3 * nn.idx + 1] + s12;
    const float c22 = p.ct[3 * nn.idx + 2] + s22 + p.eps;
    float det = c11 * c22 - c12 * c12;
    if (fabsf(det) < 1e-20f) det = 1e-20f;
    const float m11 = c22 / det, m12 = -c12 / det, m22 = c11 / det;
    const float ex = qx - mx, ey = qy - my;
    const float me1 = m11 * ex + m12 * ey;
    const float me2 = m12 * ex + m22 * ey;
    const float d2c = fminf(nn.d2, 1e9f);
    v[0] = wf * m11;
    v[1] = wf * m12;
    v[2] = wf * m22;
    v[3] = wf * (m11 * jx + m12 * jy);
    v[4] = wf * (m12 * jx + m22 * jy);
    v[5] = wf * (jx * jx * m11 + 2.f * jx * jy * m12 + jy * jy * m22);
    v[6] = wf * me1;
    v[7] = wf * me2;
    v[8] = wf * (jx * me1 + jy * me2);
    v[9] = wall * d2c;
    v[10] = wf * d2c;
    v[11] = wf;
    v[12] = wf * (ex * me1 + ey * me2);
  }
  block_reduce_store(v, p.partials);
}

// Solve the 3x3 system A x = b by Gaussian elimination with partial pivoting
// (the first largest |pivot|, as LAPACK's getrf picks it).
__device__ void solve3(const float (&A)[3][3], const float (&b)[3], float (&x)[3]) {
  float M[3][4];
  for (int r = 0; r < 3; ++r) {
    for (int c = 0; c < 3; ++c) M[r][c] = A[r][c];
    M[r][3] = b[r];
  }
  for (int k = 0; k < 3; ++k) {
    int piv = k;
    for (int r = k + 1; r < 3; ++r)
      if (fabsf(M[r][k]) > fabsf(M[piv][k])) piv = r;
    if (piv != k)
      for (int c = 0; c < 4; ++c) {
        const float t = M[k][c];
        M[k][c] = M[piv][c];
        M[piv][c] = t;
      }
    for (int r = k + 1; r < 3; ++r) {
      const float f = M[r][k] / M[k][k];
      for (int c = k; c < 4; ++c) M[r][c] -= f * M[k][c];
    }
  }
  for (int r = 2; r >= 0; --r) {
    float s = M[r][3];
    for (int c = r + 1; c < 3; ++c) s -= M[r][c] * x[c];
    x[r] = s / M[r][r];
  }
}

// One thread: the block partials summed in block order. One round: out[0:13]
// = the sums. Loop: the GN update of delta (icp.py:205-210) and
// out = [H + 1e-6 I (9, row-major), stats (4), |upd|, 0, 0].
template <bool kLoop>
__global__ void k_icp_finish(IcpProblem p, int nb, int early_exit) {
  if (kLoop && early_exit && p.ctrl[0]) return;
  float acc[kSums];
  for (int k = 0; k < kSums; ++k) {
    float s = 0.f;
    for (int b = 0; b < nb; ++b) s += p.partials[b * kLanes + k];
    acc[k] = s;
  }
  if (!kLoop) {
    for (int k = 0; k < kLanes; ++k) p.out[k] = k < kSums ? acc[k] : 0.f;
    return;
  }
  const float H[3][3] = {{acc[0] + 1e-6f, acc[1], acc[3]},
                         {acc[1], acc[2] + 1e-6f, acc[4]},
                         {acc[3], acc[4], acc[5] + 1e-6f}};
  const float g[3] = {acc[6], acc[7], acc[8]};
  float upd[3];
  solve3(H, g, upd);
  const float th = p.delta[2] + upd[2];
  p.delta[0] += upd[0];
  p.delta[1] += upd[1];
  p.delta[2] = atan2f(sinf(th), cosf(th));
  const float norm = sqrtf(upd[0] * upd[0] + upd[1] * upd[1] + upd[2] * upd[2]);
  for (int r = 0; r < 3; ++r)
    for (int c = 0; c < 3; ++c) p.out[3 * r + c] = H[r][c];
  for (int k = 0; k < 4; ++k) p.out[9 + k] = acc[9 + k];
  p.out[13] = norm;
  p.ctrl[1] += 1;
  // while_loop's cond is (k < iterations) & (|upd| >= tol): a NaN stops it.
  if (early_exit && !(norm >= p.tol)) p.ctrl[0] = 1;
}

// K8: index and squared distance of the nearest valid target.
__global__ void k_nn(const float* src, const float* tgt, const unsigned char* valid, int* idx,
                     float* d2, int P, int Q) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  const bool live = i < P;
  const Nearest nn = block_nearest(live ? src[2 * i] : 0.f, live ? src[2 * i + 1] : 0.f, tgt,
                                   valid, Q, INFINITY);
  if (live) {
    idx[i] = nn.idx;
    d2[i] = nn.d2;
  }
}

#define ICP_CHECK()                                 \
  do {                                              \
    const cudaError_t err_ = cudaGetLastError();    \
    if (err_ != cudaSuccess) return (int)err_;      \
  } while (0)

}  // namespace

extern "C" {

const char* icp_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

// Floats of the partials buffer for P source points.
int icp_partials_floats(int P) { return n_blocks(P) * kLanes; }

// K2, one round on moved points, jtheta and rotated covs: out[0:13] = the sums.
int icp_iteration(const IcpProblem* pp) {
  const IcpProblem& p = *pp;
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int nb = n_blocks(p.P);
  k_icp_iter<false><<<nb, kBlock, 0, s>>>(p, 0);
  ICP_CHECK();
  k_icp_finish<false><<<1, 1, 0, s>>>(p, nb, 0);
  ICP_CHECK();
  return 0;
}

// The IRLS loop: `iterations` rounds from p.delta, no host synchronization.
int icp_match(const IcpProblem* pp, int iterations, int early_exit) {
  const IcpProblem& p = *pp;
  const cudaStream_t s = (cudaStream_t)p.stream;
  const int nb = n_blocks(p.P);
  if (cudaMemsetAsync(p.ctrl, 0, 2 * sizeof(int), s) != cudaSuccess)
    return (int)cudaGetLastError();
  for (int it = 0; it < iterations; ++it) {
    k_icp_iter<true><<<nb, kBlock, 0, s>>>(p, early_exit);
    ICP_CHECK();
    k_icp_finish<true><<<1, 1, 0, s>>>(p, nb, early_exit);
    ICP_CHECK();
  }
  return 0;
}

// K8 on (P, 2) sources and (Q, 2) targets.
int nn_search(const float* src, const float* tgt, const unsigned char* valid, int* idx,
              float* d2, int P, int Q, void* stream) {
  k_nn<<<n_blocks(P), kBlock, 0, (cudaStream_t)stream>>>(src, tgt, valid, idx, d2, P, Q);
  ICP_CHECK();
  return 0;
}

}  // extern "C"
