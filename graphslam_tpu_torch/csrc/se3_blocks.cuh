// Device code shared by the SE(3) kernels csrc/gn6_kernel.cu (K4, K5) and
// csrc/cg_step6.cu (K7a-c): 6-vectors and row-major 6x6 blocks (and their
// 3x3 quadrants) in registers, SO(3)/SE(3) and the whitened between factor
// in the TPU kernels' form, the PCR ridge, the 3x3 and 6x6 inverses, the
// PCR factor row and apply row, and the wide persistent stages of K4 (a
// group of 6 threads a row; the block reductions and the cluster launch
// are persistent.cuh's). Line references "gn6_kernel.py:N" are to
// graphslam_tpu/ops/gn6_kernel.py.
// Included inside no namespace; everything here has internal linkage, one
// copy per library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "persistent.cuh"

namespace {

constexpr float kPi = 3.14159265358979f;

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

// ---------------------------------------------------------------------------
// Wide persistent stages: a group of 6 threads on each 6x6 row
// ---------------------------------------------------------------------------
//
// A persistent SE(3) kernel (K4's) runs on wide_shape's CTAs of kWide
// threads, one cluster or a cooperative grid. Its heavy stages give each row a group of 6 threads,
// thread a of the group on output component a (row a of a 6x6 product):
// lanes 6j .. 6j + 5 of a warp hold the warp's row slot j (j < 5; lanes 30
// and 31 hold none), so a CTA holds kSlots rows at once and every exchange
// inside a group stays in one warp (__syncwarp and per-slot shared memory).
// A group thread computes its component as the one-thread row of
// pcr6_apply_row / pcr6_factor_row / K4's H@p computes it, sum for sum in
// m6vec's and m6mul's order; binv6 stays whole in one thread of the group.
// Lighter stages (linearize, assembly, retract, cost) take one thread a row
// over the whole launch (persistent.cuh's for_flat).
//
// A reduction of one value a row (v.Hv, r.z, the cost) goes through a row
// buffer: the group's thread 0 writes the row's value, and after the next
// cluster barrier every CTA sums the buffer with wide_sum, which forms each
// 256-row block's tree of block_sum_to (one warp a block, the same pairs
// in the same order, in registers and shuffles) and adds the blocks in
// order as sum_partials does. So every number is bitwise the staged
// launches' (gn6_kernel.cu's k6_* sequence), at any cluster size and any
// number of passes a CTA walks.

constexpr int kWide = 384;               // threads a CTA
constexpr int kGroupRows = 5;            // row slots a warp (30 of its 32 lanes)
constexpr int kSlots = kWide / 32 * kGroupRows;
constexpr int kSlotFloats = 72;          // shared scratch a slot: two 6x6 blocks

// The launch shape of the wide kernels over N rows (persistent.cuh's
// pass_shape at kSlots rows a CTA): one cluster where one pass over the
// rows takes at most kMaxClusterCtas CTAs, else a cooperative grid.
template <typename... KArgs>
cudaError_t wide_shape(void (*kernel)(KArgs...), long long N, Shape& sh) {
  return pass_shape(kernel, kWide, kSlots, N, sh);
}

// f(n, a, live, S) for every row n < N, on the 6 threads a = 0..5 of its
// group, with S the slot's kSlotFloats floats of shared scratch. Every
// thread of the cluster makes the same number of calls (live = false past
// N and on lanes 30 and 31), so f may call __syncwarp.
// The CTA's group scratch, kSlotFloats floats a slot (one array for every
// stage: a __shared__ array in the template below would be one per stage).
__device__ float* group_scratch() {
  __shared__ float scratch[kSlots * kSlotFloats];
  return scratch;
}

template <typename F>
__device__ __forceinline__ void for_groups(int N, F f) {
  float* scratch = group_scratch();
  const int lane = threadIdx.x & 31;
  const bool on = lane < 6 * kGroupRows;
  const int slot = (threadIdx.x >> 5) * kGroupRows + (on ? lane / 6 : 0);
  const int a = on ? lane % 6 : 0;
  const long long span = (long long)gridDim.x * kSlots;
  const int passes = (int)((N + span - 1) / span);
  for (int ps = 0; ps < passes; ++ps) {
    const long long n = ((long long)ps * gridDim.x + blockIdx.x) * kSlots + slot;
    f((int)n, a, on && n < N, scratch + slot * kSlotFloats);
  }
}

// The sum of vals[0:M) in the staged launches' order: per 256-row block the
// tree of block_sum_to, then the blocks in index order from 0.f as
// sum_partials adds them. Every thread of the CTA calls it and gets the sum.
__device__ float wide_sum(const float* vals, int M) {
  __shared__ float part[kWide / 32];
  __shared__ float total;
  const int nb = n_blocks(M), warps = blockDim.x >> 5;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float acc = 0.f;
  for (int b0 = 0; b0 < nb; b0 += warps) {
    const int blk = b0 + warp;
    float v[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const long long i = (long long)blk * kThreads + lane + 32 * j;
      v[j] = blk < nb && i < M ? vals[i] : 0.f;
    }
    // block_sum_to's strides 128, 64 and 32 in registers, 16 .. 1 across lanes
#pragma unroll
    for (int j = 0; j < 4; ++j) v[j] += v[j + 4];
    v[0] += v[2];
    v[1] += v[3];
    v[0] += v[1];
#pragma unroll
    for (int stride = 16; stride > 0; stride >>= 1)
      v[0] += __shfl_down_sync(0xffffffffu, v[0], stride);
    if (lane == 0) part[warp] = v[0];
    __syncthreads();
    if (threadIdx.x == 0)
      for (int i = 0; i < warps && b0 + i < nb; ++i) acc += part[i];
    __syncthreads();
  }
  if (threadIdx.x == 0) total = acc;
  __syncthreads();
  return total;
}

// Component a of pcr6_apply_row at row n (live), its group's slot scratch
// S: out[n][a] = b[n][a] - (A[k] b[n-h])[a] - (G[k] b[n+h])[a], then times
// Dinv[n] at the last level. With vals at the last level, the group's
// thread 0 writes rdot[n].out[n] (v6dot's order) to vals[n].
__device__ __forceinline__ void apply6_lane(int n, int a, bool live, float* S, int N, int k,
                                            const float* A, const float* G, const float* Dinv,
                                            const float* in, float* out, int last,
                                            const float* rdot, float* vals) {
  const int h = 1 << k;
  float o = 0.f;
  if (live) {
    const long long kn = (long long)k * N + n;
    o = in[6LL * n + a];
    if (n - h >= 0) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += A[36 * kn + 6 * a + q] * in[6LL * (n - h) + q];
      o -= s;
    }
    if (n + h < N) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += G[36 * kn + 6 * a + q] * in[6LL * (n + h) + q];
      o -= s;
    }
  }
  if (last) {
    if (live) S[a] = o;
    __syncwarp();
    if (live) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += Dinv[36LL * n + 6 * a + q] * S[q];
      o = s;
    }
    __syncwarp();
    if (vals) {
      if (live) S[a] = o;
      __syncwarp();
      if (live && a == 0) {
        float s = 0.f;
#pragma unroll
        for (int q = 0; q < 6; ++q) s += rdot[6LL * n + q] * S[q];
        vals[n] = s;
      }
      __syncwarp();
    }
  }
  if (live) out[6LL * n + a] = o;
}

// Row a of L[m] at a PCR level: the level's own Ls, or at level 0 row a of
// U0[m-1]^T (zero at m = 0), as load_L.
__device__ __forceinline__ float L_at(const float* Ls, const float* U0, int m, int a, int c) {
  if (Ls) return Ls[36LL * m + 6 * a + c];
  return m >= 1 ? U0[36LL * (m - 1) + 6 * c + a] : 0.f;
}

__device__ __forceinline__ void st36_at(float* S, const M6& M) {
#pragma unroll
  for (int e = 0; e < 36; ++e) S[e] = M.m[e];
}

// Row a of pcr6_factor_row at row n (live), on the group's scratch S (two
// 6x6 blocks, S0 = S and S1 = S + 36): threads 0 and 1 of the group invert
// the ridged D[n-h] into S0 and D[n+h] into S1 (binv6 whole in one
// thread), each thread forms row a of alpha = L[n] S0 and gamma = U[n] S1,
// then of alpha U[n-h] and gamma L[n+h] with those blocks staged in S0 and
// S1, and of D' = ridge(D[n]) - alpha U[n-h] - gamma L[n+h]; the last level
// gathers D' in S0 and thread 0 inverts it, else row a of L' = -alpha
// L[n-h] and U' = -gamma U[n+h].
__device__ __forceinline__ void factor6_lane(int n, int a, bool live, float* S, int N, int k,
                                             float eps, const float* Ds, const float* Us,
                                             const float* Ls, const float* U0, float* A,
                                             float* G, float* Dinv, float* Dd, float* Ud,
                                             float* Ld, int last) {
  const int h = 1 << k;
  const float eps6 = eps / 6.f;
  const bool has_m = live && n - h >= 0, has_p = live && n + h < N;
  float* S0 = S;
  float* S1 = S + 36;
  if (a < 2 && (a == 0 ? has_m : has_p)) {
    const int m = a == 0 ? n - h : n + h;
    st36_at(a == 0 ? S0 : S1, binv6(ridge(ld36(Ds, m), eps6)));
  }
  float Dn[6], alpha[6], gamma[6];
  if (live) {
    const float* d = Ds + 36LL * n;
    const float tr = d[0] + d[7] + d[14] + d[21] + d[28] + d[35];
    const float r = fabsf(tr) * eps6 + 1e-8f;
#pragma unroll
    for (int c = 0; c < 6; ++c) Dn[c] = d[6 * a + c];
#pragma unroll
    for (int c = 0; c < 6; ++c)
      if (c == a) Dn[c] += r;
  }
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 6; ++c) alpha[c] = gamma[c] = 0.f;
  if (has_m) {
    float Lr[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) Lr[q] = L_at(Ls, U0, n, a, q);
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += Lr[q] * S0[6 * q + c];
      alpha[c] = s;
    }
  }
  if (has_p) {
    float Ur[6];
#pragma unroll
    for (int q = 0; q < 6; ++q) Ur[q] = Us[36LL * n + 6 * a + q];
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += Ur[q] * S1[6 * q + c];
      gamma[c] = s;
    }
  }
  __syncwarp();
  if (has_m)
#pragma unroll
    for (int c = 0; c < 6; ++c) S0[6 * a + c] = Us[36LL * (n - h) + 6 * a + c];
  if (has_p)
#pragma unroll
    for (int c = 0; c < 6; ++c) S1[6 * a + c] = L_at(Ls, U0, n + h, a, c);
  __syncwarp();
  float Dnew[6];
#pragma unroll
  for (int c = 0; c < 6; ++c) Dnew[c] = live ? Dn[c] : 0.f;
  if (has_m)
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += alpha[q] * S0[6 * q + c];
      Dnew[c] -= s;
    }
  if (has_p)
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      float s = 0.f;
#pragma unroll
      for (int q = 0; q < 6; ++q) s += gamma[q] * S1[6 * q + c];
      Dnew[c] -= s;
    }
  const long long kn = (long long)k * N + n;
  if (live)
#pragma unroll
    for (int c = 0; c < 6; ++c) {
      A[36 * kn + 6 * a + c] = alpha[c];
      G[36 * kn + 6 * a + c] = gamma[c];
    }
  __syncwarp();
  if (last) {
    if (live)
#pragma unroll
      for (int c = 0; c < 6; ++c) S0[6 * a + c] = Dnew[c];
    __syncwarp();
    if (live && a == 0) {
      M6 M;
#pragma unroll
      for (int e = 0; e < 36; ++e) M.m[e] = S0[e];
      st36_at(S1, binv6(ridge(M, eps6)));
    }
    __syncwarp();
    if (live)
#pragma unroll
      for (int c = 0; c < 6; ++c) Dinv[36LL * n + 6 * a + c] = S1[6 * a + c];
    __syncwarp();
    return;
  }
  if (live)
#pragma unroll
    for (int c = 0; c < 6; ++c) Dd[36LL * n + 6 * a + c] = Dnew[c];
  if (has_m)
#pragma unroll
    for (int c = 0; c < 6; ++c) S0[6 * a + c] = L_at(Ls, U0, n - h, a, c);
  if (has_p)
#pragma unroll
    for (int c = 0; c < 6; ++c) S1[6 * a + c] = Us[36LL * (n + h) + 6 * a + c];
  __syncwarp();
#pragma unroll
  for (int c = 0; c < 6; ++c) {
    float l = 0.f, u = 0.f;
    if (has_m) {
#pragma unroll
      for (int q = 0; q < 6; ++q) l += alpha[q] * S0[6 * q + c];
    }
    if (has_p) {
#pragma unroll
      for (int q = 0; q < 6; ++q) u += gamma[q] * S1[6 * q + c];
    }
    if (live) {
      Ld[36LL * n + 6 * a + c] = -l;
      Ud[36LL * n + 6 * a + c] = -u;
    }
  }
  __syncwarp();
}

// The K PCR factor levels (factor6_lane), a barrier after each: level 0
// reads D and U (L from U), later levels the ping-pong buffers (PD, PU,
// PL)[(k - 1) & 1] and write [k & 1]; the last writes Dinv.
__device__ __forceinline__ void factor6_stages(int N, int K, float eps, const float* D,
                                               const float* U, float* PD0, float* PD1,
                                               float* PU0, float* PU1, float* PL0, float* PL1,
                                               float* A, float* G, float* Dinv) {
  for (int k = 0; k < K; ++k) {
    const bool odd = (k - 1) & 1;
    const float* Ds = k == 0 ? D : odd ? PD1 : PD0;
    const float* Us = k == 0 ? U : odd ? PU1 : PU0;
    const float* Ls = k == 0 ? nullptr : odd ? PL1 : PL0;
    float* Dd = k & 1 ? PD1 : PD0;
    float* Ud = k & 1 ? PU1 : PU0;
    float* Ld = k & 1 ? PL1 : PL0;
    const int last = k == K - 1;
    for_groups(N, [&](int n, int a, bool live, float* S) {
      factor6_lane(n, a, live, S, N, k, eps, Ds, Us, Ls, U, A, G, Dinv, Dd, Ud, Ld, last);
    });
    stage_sync();
  }
}

// The K PCR apply levels (apply6_lane), a barrier after each: in -> t0 ->
// t1 -> t0 ... -> out, the last level times Dinv with rdot.out of each row
// in vals.
__device__ __forceinline__ void apply6_stages(int N, int K, const float* A, const float* G,
                                              const float* Dinv, const float* in, float* t0,
                                              float* t1, float* out, const float* rdot,
                                              float* vals) {
  const float* src = in;
  for (int k = 0; k < K; ++k) {
    const int last = k == K - 1;
    float* dst = last ? out : k & 1 ? t1 : t0;
    for_groups(N, [&](int n, int a, bool live, float* S) {
      apply6_lane(n, a, live, S, N, k, A, G, Dinv, src, dst, last, rdot, vals);
    });
    src = dst;
    stage_sync();
  }
}

}  // namespace
