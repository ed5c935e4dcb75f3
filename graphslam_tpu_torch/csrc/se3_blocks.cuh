// Device code shared by the SE(3) kernels csrc/gn6_kernel.cu (K4, K5) and
// csrc/cg_step6.cu (K7a-c): 6-vectors and row-major 6x6 blocks (and their
// 3x3 quadrants) in registers, SO(3)/SE(3) and the whitened between factor
// in the TPU kernels' form, the PCR ridge, the 3x3 and 6x6 inverses, the PCR
// factor row and apply row, and the deterministic block reductions. Line
// references "gn6_kernel.py:N" are to graphslam_tpu/ops/gn6_kernel.py.
// Included inside no namespace; everything here has internal linkage, one
// copy per library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;
constexpr float kPi = 3.14159265358979f;
constexpr float kTiny = 1e-30f;

__host__ __device__ inline int n_blocks(long long n) {
  return (int)((n + kThreads - 1) / kThreads);
}

// ---------------------------------------------------------------------------
// Small vectors and row-major blocks in registers
// ---------------------------------------------------------------------------

struct V3 { float v[3]; };
struct M3 { float m[9]; };
struct V6 { float v[6]; };
struct M6 { float m[36]; };
struct Pose { M3 R; V3 t; };

__device__ __forceinline__ M3 m3zero() {
  M3 r;
#pragma unroll
  for (int e = 0; e < 9; ++e) r.m[e] = 0.f;
  return r;
}
__device__ __forceinline__ M3 mmul(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int c = 0; c < 3; ++c)
      r.m[3 * a + c] = A.m[3 * a] * B.m[c] + A.m[3 * a + 1] * B.m[3 + c] +
                       A.m[3 * a + 2] * B.m[6 + c];
  return r;
}
__device__ __forceinline__ M3 mT(const M3& A) {
  return M3{{A.m[0], A.m[3], A.m[6], A.m[1], A.m[4], A.m[7], A.m[2], A.m[5], A.m[8]}};
}
__device__ __forceinline__ V3 mvec(const M3& A, const V3& x) {
  V3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.v[a] = A.m[3 * a] * x.v[0] + A.m[3 * a + 1] * x.v[1] + A.m[3 * a + 2] * x.v[2];
  return r;
}
__device__ __forceinline__ M3 madd(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int e = 0; e < 9; ++e) r.m[e] = A.m[e] + B.m[e];
  return r;
}
__device__ __forceinline__ M3 msub(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int e = 0; e < 9; ++e) r.m[e] = A.m[e] - B.m[e];
  return r;
}
__device__ __forceinline__ M3 mscale(const M3& A, float s) {
  M3 r;
#pragma unroll
  for (int e = 0; e < 9; ++e) r.m[e] = A.m[e] * s;
  return r;
}
__device__ __forceinline__ M3 hat(const V3& w) {
  return M3{{0.f, -w.v[2], w.v[1], w.v[2], 0.f, -w.v[0], -w.v[1], w.v[0], 0.f}};
}
__device__ __forceinline__ V3 vneg(const V3& a) { return V3{{-a.v[0], -a.v[1], -a.v[2]}}; }

__device__ __forceinline__ V6 v6zero() {
  V6 r;
#pragma unroll
  for (int i = 0; i < 6; ++i) r.v[i] = 0.f;
  return r;
}
__device__ __forceinline__ M6 m6zero() {
  M6 r;
#pragma unroll
  for (int e = 0; e < 36; ++e) r.m[e] = 0.f;
  return r;
}
__device__ __forceinline__ V6 ld6(const float* a, long long i) {
  V6 r;
#pragma unroll
  for (int k = 0; k < 6; ++k) r.v[k] = a[6 * i + k];
  return r;
}
__device__ __forceinline__ void st6(float* a, long long i, const V6& x) {
#pragma unroll
  for (int k = 0; k < 6; ++k) a[6 * i + k] = x.v[k];
}
__device__ __forceinline__ M6 ld36(const float* a, long long i) {
  M6 r;
#pragma unroll
  for (int e = 0; e < 36; ++e) r.m[e] = a[36 * i + e];
  return r;
}
__device__ __forceinline__ void st36(float* a, long long i, const M6& x) {
#pragma unroll
  for (int e = 0; e < 36; ++e) a[36 * i + e] = x.m[e];
}
__device__ __forceinline__ M6 m6mul(const M6& A, const M6& B) {
  M6 r;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += A.m[6 * a + k] * B.m[6 * k + c];
      r.m[6 * a + c] = s;
    }
  return r;
}
// A^T B without forming A^T
__device__ __forceinline__ M6 m6Tmul(const M6& A, const M6& B) {
  M6 r;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 6; ++k) s += A.m[6 * k + a] * B.m[6 * k + c];
      r.m[6 * a + c] = s;
    }
  return r;
}
__device__ __forceinline__ M6 m6T(const M6& A) {
  M6 r;
#pragma unroll
  for (int a = 0; a < 6; ++a)
#pragma unroll
    for (int c = 0; c < 6; ++c) r.m[6 * a + c] = A.m[6 * c + a];
  return r;
}
__device__ __forceinline__ V6 m6vec(const M6& A, const V6& x) {
  V6 r;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s += A.m[6 * a + k] * x.v[k];
    r.v[a] = s;
  }
  return r;
}
__device__ __forceinline__ V6 m6Tvec(const M6& A, const V6& x) {
  V6 r;
#pragma unroll
  for (int a = 0; a < 6; ++a) {
    float s = 0.f;
#pragma unroll
    for (int k = 0; k < 6; ++k) s += A.m[6 * k + a] * x.v[k];
    r.v[a] = s;
  }
  return r;
}
__device__ __forceinline__ void m6add(M6& A, const M6& B) {
#pragma unroll
  for (int e = 0; e < 36; ++e) A.m[e] += B.m[e];
}
__device__ __forceinline__ void v6add(V6& a, const V6& b) {
#pragma unroll
  for (int i = 0; i < 6; ++i) a.v[i] += b.v[i];
}
__device__ __forceinline__ float v6dot(const V6& a, const V6& b) {
  float s = 0.f;
#pragma unroll
  for (int i = 0; i < 6; ++i) s += a.v[i] * b.v[i];
  return s;
}
// Quadrant (r0, c0) in {0, 3} of a 6x6, and its inverse.
__device__ __forceinline__ M3 quad(const M6& A, int r0, int c0) {
  M3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) r.m[3 * a + b] = A.m[6 * (r0 + a) + c0 + b];
  return r;
}
__device__ __forceinline__ void set_quad(M6& A, int r0, int c0, const M3& Q) {
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int b = 0; b < 3; ++b) A.m[6 * (r0 + a) + c0 + b] = Q.m[3 * a + b];
}
__device__ __forceinline__ M6 from_quads(const M3& P, const M3& Q, const M3& R, const M3& S) {
  M6 A;
  set_quad(A, 0, 0, P);
  set_quad(A, 0, 3, Q);
  set_quad(A, 3, 0, R);
  set_quad(A, 3, 3, S);
  return A;
}

// ---------------------------------------------------------------------------
// SO(3) / SE(3), mirroring geometry/so3.py and geometry/se3.py (the TPU
// kernel's row-level copies, gn6_kernel.py:282-535)
// ---------------------------------------------------------------------------

// a I + b hat(w) + c hat(w)^2, with hat(w)^2 = w w^T - theta^2 I.
__device__ __forceinline__ M3 aI_bW_cW2(const V3& w, float a, float b, float c) {
  const float x = w.v[0], y = w.v[1], z = w.v[2];
  const float d = a - c * (x * x + y * y + z * z);
  return M3{{d + c * x * x, -b * z + c * x * y, b * y + c * x * z,
             b * z + c * y * x, d + c * y * y, -b * x + c * y * z,
             -b * y + c * z * x, b * x + c * z * y, d + c * z * z}};
}

__device__ M3 so3_exp(const V3& w) {
  const float theta2 = w.v[0] * w.v[0] + w.v[1] * w.v[1] + w.v[2] * w.v[2];
  const float theta = sqrtf(theta2);
  const bool small = theta < 1e-6f;
  const float ts = small ? 1.f : theta;
  const float sh = sinf(ts / 2.f);
  const float a = small ? 1.f - theta2 / 6.f : sinf(ts) / ts;
  const float b = small ? 0.5f - theta2 / 24.f : 2.f * sh * sh / (ts * ts);
  return aI_bW_cW2(w, 1.f, a, b);
}

// Rotation vector of R (so3.py::log): k(c) vee(R - R^T)/2 with k from
// acosf in the generic branch, a series in u = 1 - c for c > 0.95, and the
// axis from the largest column of R + I (first maximum wins) for c < -0.99.
__device__ V3 so3_log(const M3& R) {
  const float tr = R.m[0] + R.m[4] + R.m[8];
  const float c = fminf(fmaxf((tr - 1.f) / 2.f, -1.f), 1.f);
  const V3 ws{{(R.m[7] - R.m[5]) / 2.f, (R.m[2] - R.m[6]) / 2.f, (R.m[3] - R.m[1]) / 2.f}};
  if (c < -0.99f) {
    const float v = 1.f + c;
    const float theta_pi = kPi - sqrtf(fmaxf(2.f * v, 0.f)) * (1.f + v / 12.f);
    float n2[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float c0 = R.m[j] + (j == 0 ? 1.f : 0.f);
      const float c1 = R.m[3 + j] + (j == 1 ? 1.f : 0.f);
      const float c2 = R.m[6 + j] + (j == 2 ? 1.f : 0.f);
      n2[j] = c0 * c0 + c1 * c1 + c2 * c2;
    }
    const int k = (n2[0] >= n2[1] && n2[0] >= n2[2]) ? 0 : (n2[1] >= n2[2] ? 1 : 2);
    V3 axis{{R.m[k] + (k == 0 ? 1.f : 0.f), R.m[3 + k] + (k == 1 ? 1.f : 0.f),
             R.m[6 + k] + (k == 2 ? 1.f : 0.f)}};
    const float inv_n = 1.f / sqrtf(fmaxf(axis.v[0] * axis.v[0] + axis.v[1] * axis.v[1] +
                                          axis.v[2] * axis.v[2], 1e-12f));
    const float dot = axis.v[0] * ws.v[0] + axis.v[1] * ws.v[1] + axis.v[2] * ws.v[2];
    const float s = theta_pi * inv_n * (dot < 0.f ? -1.f : 1.f);
    return V3{{axis.v[0] * s, axis.v[1] * s, axis.v[2] * s}};
  }
  float k;
  if (c > 0.95f) {
    const float u = 1.f - c;
    k = 1.f + u / 3.f + (2.f / 15.f) * u * u + (2.f / 35.f) * u * u * u;
  } else {
    k = acosf(c) / sqrtf(fmaxf(1.f - c * c, 1e-12f));
  }
  return V3{{k * ws.v[0], k * ws.v[1], k * ws.v[2]}};
}

__device__ M3 so3_jl(const V3& w) {
  const float theta2 = w.v[0] * w.v[0] + w.v[1] * w.v[1] + w.v[2] * w.v[2];
  const float theta = sqrtf(theta2);
  const bool small = theta < 1e-6f;
  const float ts = small ? 1.f : theta;
  const float sh = sinf(ts / 2.f);
  const float A = small ? 0.5f - theta2 / 24.f : 2.f * sh * sh / (ts * ts);
  const float B = small ? 1.f / 6.f - theta2 / 120.f : (ts - sinf(ts)) / (ts * ts * ts);
  return aI_bW_cW2(w, 1.f, A, B);
}

__device__ M3 so3_jl_inv(const V3& w) {
  const float theta2 = w.v[0] * w.v[0] + w.v[1] * w.v[1] + w.v[2] * w.v[2];
  const float theta = sqrtf(theta2);
  const bool small = theta < 1e-6f;
  const float ts = small ? 1.f : theta;
  const float half = ts / 2.f;
  const float cot_term = small ? 1.f / 12.f + theta2 / 720.f
                               : (1.f - half * cosf(half) / sinf(half)) / (ts * ts);
  return aI_bW_cW2(w, 1.f, -0.5f, cot_term);
}

// Barfoot's Q(rho, phi) (se3.py::_Q_matrix): Taylor forms below 0.7 rad.
__device__ M3 q_matrix(const V3& rho, const V3& phi) {
  const float theta2 = phi.v[0] * phi.v[0] + phi.v[1] * phi.v[1] + phi.v[2] * phi.v[2];
  const float theta = sqrtf(theta2);
  const bool small = theta < 0.7f;
  const float ts = small ? 1.f : theta;
  const float ts2 = ts * ts, ts3 = ts2 * ts;
  const float st = sinf(ts), ct = cosf(ts);
  const float c1 = small ? 1.f / 6.f - theta2 / 120.f + theta2 * theta2 / 5040.f
                         : (ts - st) / ts3;
  const float c2 = small ? -1.f / 24.f + theta2 / 720.f - theta2 * theta2 / 40320.f
                         : (1.f - ts2 / 2.f - ct) / (ts2 * ts2);
  const float c3i = small ? -1.f / 120.f + theta2 / 5040.f - theta2 * theta2 / 362880.f
                          : (ts - st - ts3 / 6.f) / (ts3 * ts2);
  const M3 rx = hat(rho), px = hat(phi);
  const M3 pxrx = mmul(px, rx), rxpx = mmul(rx, px);
  const M3 pxrxpx = mmul(pxrx, px);
  const M3 t1 = mscale(rx, 0.5f);
  const M3 t2 = mscale(madd(madd(pxrx, rxpx), pxrxpx), c1);
  const M3 t3 = mscale(msub(madd(mmul(px, pxrx), mmul(rxpx, px)), mscale(pxrxpx, 3.f)), -c2);
  const M3 t4 = mscale(madd(mmul(pxrxpx, px), mmul(px, pxrxpx)), -0.5f * (c2 - 3.f * c3i));
  return madd(madd(t1, t2), madd(t3, t4));
}

// Inverse SE(3) right Jacobian Jl^{-1}(-xi) (se3.py:143-162), xi = [rho, phi].
__device__ M6 se3_jr_inv(const V6& xi) {
  const V3 nrho{{-xi.v[0], -xi.v[1], -xi.v[2]}};
  const V3 nphi{{-xi.v[3], -xi.v[4], -xi.v[5]}};
  const M3 Jinv = so3_jl_inv(nphi);
  const M3 TR = mscale(mmul(mmul(Jinv, q_matrix(nrho, nphi)), Jinv), -1.f);
  return from_quads(Jinv, TR, m3zero(), Jinv);
}

__device__ __forceinline__ Pose ld_pose(const float* a, long long i) {
  Pose p;
#pragma unroll
  for (int e = 0; e < 9; ++e) p.R.m[e] = a[12 * i + e];
#pragma unroll
  for (int e = 0; e < 3; ++e) p.t.v[e] = a[12 * i + 9 + e];
  return p;
}
__device__ __forceinline__ void st_pose(float* a, long long i, const Pose& p) {
#pragma unroll
  for (int e = 0; e < 9; ++e) a[12 * i + e] = p.R.m[e];
#pragma unroll
  for (int e = 0; e < 3; ++e) a[12 * i + 9 + e] = p.t.v[e];
}

// a^-1 b
__device__ __forceinline__ Pose se3_between(const Pose& a, const Pose& b) {
  const M3 RaT = mT(a.R);
  const V3 d{{b.t.v[0] - a.t.v[0], b.t.v[1] - a.t.v[1], b.t.v[2] - a.t.v[2]}};
  return Pose{mmul(RaT, b.R), mvec(RaT, d)};
}
__device__ __forceinline__ Pose se3_inverse(const Pose& p) {
  const M3 RT = mT(p.R);
  return Pose{RT, vneg(mvec(RT, p.t))};
}
__device__ __forceinline__ Pose se3_compose(const Pose& a, const Pose& b) {
  const V3 rt = mvec(a.R, b.t);
  return Pose{mmul(a.R, b.R), V3{{rt.v[0] + a.t.v[0], rt.v[1] + a.t.v[1], rt.v[2] + a.t.v[2]}}};
}
__device__ V6 se3_log(const Pose& p) {
  const V3 phi = so3_log(p.R);
  const V3 rho = mvec(so3_jl_inv(phi), p.t);
  return V6{{rho.v[0], rho.v[1], rho.v[2], phi.v[0], phi.v[1], phi.v[2]}};
}
__device__ Pose se3_exp(const V6& xi) {
  const V3 rho{{xi.v[0], xi.v[1], xi.v[2]}}, phi{{xi.v[3], xi.v[4], xi.v[5]}};
  return Pose{so3_exp(phi), mvec(so3_jl(phi), rho)};
}
// [[R, hat(t) R], [0, R]]
__device__ M6 se3_adjoint(const Pose& p) {
  return from_quads(p.R, mmul(hat(p.t), p.R), m3zero(), p.R);
}
// One polar-Newton step R (1.5 I - 0.5 R^T R) (so3.py::normalize).
__device__ M3 renorm(const M3& R) {
  M3 M = mscale(mmul(mT(R), R), -0.5f);
  M.m[0] += 1.5f;
  M.m[4] += 1.5f;
  M.m[8] += 1.5f;
  return mmul(R, M);
}

// Whitened SE(3) between factor (gn6_kernel.py:548-574): rw, Jiw, Jjw.
__device__ void linearize_edge(const Pose& xi, const Pose& xj, const Pose& z, const M6& W,
                               float huber_delta, V6& rw, M6& Jiw, M6& Jjw) {
  const Pose h = se3_between(xi, xj);
  const V6 r = se3_log(se3_between(z, h));
  const M6 Jr_inv = se3_jr_inv(r);
  M6 Ji = m6mul(Jr_inv, se3_adjoint(se3_inverse(h)));
#pragma unroll
  for (int e = 0; e < 36; ++e) Ji.m[e] = -Ji.m[e];
  rw = m6vec(W, r);
  Jiw = m6mul(W, Ji);
  Jjw = m6mul(W, Jr_inv);
  if (huber_delta > 0.f) {
    const float n = sqrtf(fmaxf(v6dot(rw, rw), 1e-24f));
    const float sw = sqrtf(fminf(1.f, huber_delta / n));
#pragma unroll
    for (int i = 0; i < 6; ++i) rw.v[i] *= sw;
#pragma unroll
    for (int e = 0; e < 36; ++e) {
      Jiw.m[e] *= sw;
      Jjw.m[e] *= sw;
    }
  }
}

// Whitened residual only (gn6_kernel.py:577-580), for the cost.
__device__ __forceinline__ V6 residual_edge(const Pose& xi, const Pose& xj, const Pose& z,
                                            const M6& W) {
  return m6vec(W, se3_log(se3_between(z, se3_between(xi, xj))));
}

// PCR ridge of the TPU kernel (gn6_kernel.py:127-137): + (eps/6 |tr| + 1e-8) I.
__device__ __forceinline__ M6 ridge(M6 D, float eps6) {
  const float tr = D.m[0] + D.m[7] + D.m[14] + D.m[21] + D.m[28] + D.m[35];
  const float r = fabsf(tr) * eps6 + 1e-8f;
#pragma unroll
  for (int i = 0; i < 6; ++i) D.m[7 * i] += r;
  return D;
}

// 3x3 inverse of the TPU kernels (gn_kernel.py:289-300): row a is adj row a
// times 1/det_a, det_a = sum_s M[a,s] adj[a,s], |det| clamped to 1e-20.
__device__ M3 binv3(const M3& M) {
  M3 adj;
#pragma unroll
  for (int a = 0; a < 3; ++a)
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int s1 = (s + 1) % 3, s2 = (s + 2) % 3;
      const int a1 = (a + 1) % 3, a2 = (a + 2) % 3;
      adj.m[3 * a + s] = M.m[3 * s1 + a1] * M.m[3 * s2 + a2] - M.m[3 * s1 + a2] * M.m[3 * s2 + a1];
    }
  M3 inv;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float det = 0.f;
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      const int s = (a + d) % 3;
      det += M.m[3 * a + s] * adj.m[3 * a + s];
    }
    const float id = 1.f / (fabsf(det) < 1e-20f ? 1e-20f : det);
#pragma unroll
    for (int s = 0; s < 3; ++s) inv.m[3 * a + s] = adj.m[3 * a + s] * id;
  }
  return inv;
}

// 6x6 inverse via the Schur complement of S (gn6_kernel.py:140-149):
// [[P, Q], [R, S]]^-1 = [[TL, TR], [TR^T, BR]].
__device__ M6 binv6(const M6& M) {
  const M3 Q = quad(M, 0, 3);
  const M3 Sinv = binv3(quad(M, 3, 3));
  const M3 QSi = mmul(Q, Sinv);
  const M3 TL = binv3(msub(quad(M, 0, 0), mmul(QSi, mT(Q))));
  const M3 TR = mscale(mmul(TL, QSi), -1.f);
  const M3 BR = msub(Sinv, mmul(mT(QSi), TR));
  return from_quads(TL, TR, mT(TR), BR);
}

// ---------------------------------------------------------------------------
// Deterministic reductions: a fixed shared-memory tree per block, then every
// block sums the per-block partials in index order.
// ---------------------------------------------------------------------------

__device__ void block_sum_to(float val, float* part) {
  __shared__ float s[kThreads];
  const int t = threadIdx.x;
  s[t] = val;
  __syncthreads();
  for (int stride = kThreads / 2; stride > 0; stride >>= 1) {
    if (t < stride) s[t] += s[t + stride];
    __syncthreads();
  }
  if (t == 0) part[blockIdx.x] = s[0];
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

// Chain sub-diagonal L[m] = U[m-1]^T at level 0; the level's own L after.
__device__ __forceinline__ M6 load_L(const float* Ls, const float* U0, int m) {
  if (Ls) return ld36(Ls, m);
  return m >= 1 ? m6T(ld36(U0, m - 1)) : m6zero();
}

// One PCR level at row n (gn6_kernel.py:171-193): with h = 2^k,
//   alpha = L[n] Dinv[n-h], gamma = U[n] Dinv[n+h]   (zero off the ends)
//   D' = D - alpha U[n-h] - gamma L[n+h], L' = -alpha L[n-h], U' = -gamma U[n+h]
// where D is the ridged block and L at level 0 is U0[n-1]^T. The row
// inverts its neighbours' blocks itself, so one launch per level suffices.
// Writes alpha and gamma to A and G at (k, n); the last level writes the
// final inverse to Dinv instead of D', L', U'.
__device__ __forceinline__ void pcr6_factor_row(int n, int N, int k, float eps, const float* Ds,
                                                const float* Us, const float* Ls, const float* U0,
                                                float* A, float* G, float* Dinv, float* Dd,
                                                float* Ud, float* Ld, int last) {
  const int h = 1 << k;
  const float eps6 = eps / 6.f;
  const bool has_m = n - h >= 0, has_p = n + h < N;
  const long long kn = (long long)k * N + n;
  M6 Dnew = ridge(ld36(Ds, n), eps6);
  M6 alpha = m6zero(), gamma = m6zero();
  if (has_m) {
    alpha = m6mul(load_L(Ls, U0, n), binv6(ridge(ld36(Ds, n - h), eps6)));
    const M6 aU = m6mul(alpha, ld36(Us, n - h));
#pragma unroll
    for (int e = 0; e < 36; ++e) Dnew.m[e] -= aU.m[e];
  }
  if (has_p) {
    gamma = m6mul(ld36(Us, n), binv6(ridge(ld36(Ds, n + h), eps6)));
    const M6 gL = m6mul(gamma, load_L(Ls, U0, n + h));
#pragma unroll
    for (int e = 0; e < 36; ++e) Dnew.m[e] -= gL.m[e];
  }
  st36(A, kn, alpha);
  st36(G, kn, gamma);
  if (last) {
    st36(Dinv, n, binv6(ridge(Dnew, eps6)));
    return;
  }
  st36(Dd, n, Dnew);
  M6 Lnew = has_m ? m6mul(alpha, load_L(Ls, U0, n - h)) : m6zero();
#pragma unroll
  for (int e = 0; e < 36; ++e) Lnew.m[e] = -Lnew.m[e];
  st36(Ld, n, Lnew);
  M6 Unew = has_p ? m6mul(gamma, ld36(Us, n + h)) : m6zero();
#pragma unroll
  for (int e = 0; e < 36; ++e) Unew.m[e] = -Unew.m[e];
  st36(Ud, n, Unew);
}

// One PCR apply level at row n (gn6_kernel.py:196-207): out[n] = b[n] - A[k]
// b[n-h] - G[k] b[n+h], times Dinv[n] at the last level; returns out[n].
__device__ __forceinline__ V6 pcr6_apply_row(int n, int N, int k, const float* A, const float* G,
                                             const float* Dinv, const float* in, float* out,
                                             int last) {
  const int h = 1 << k;
  const long long kn = (long long)k * N + n;
  V6 o = ld6(in, n);
  if (n - h >= 0) {
    const V6 am = m6vec(ld36(A, kn), ld6(in, n - h));
#pragma unroll
    for (int a = 0; a < 6; ++a) o.v[a] -= am.v[a];
  }
  if (n + h < N) {
    const V6 gp = m6vec(ld36(G, kn), ld6(in, n + h));
#pragma unroll
    for (int a = 0; a < 6; ++a) o.v[a] -= gp.v[a];
  }
  if (last) o = m6vec(ld36(Dinv, n), o);
  st6(out, n, o);
  return o;
}

}  // namespace
