// Device code shared by the SE(2) kernels csrc/gn_kernel.cu (K1, K3) and
// csrc/cg_step.cu (K6a-c): 3-vectors and row-major 3x3 blocks in registers,
// SE(2) and the whitened between factor in the TPU kernels' form, the PCR
// ridge, inverse, factor row and apply row, and the PCR factor and apply
// levels as persistent stages (K1, K3 and K6c, on the routine of
// persistent.cuh). Line references "gn_kernel.py:N" are to
// graphslam_tpu/ops/gn_kernel.py.
// Included inside no namespace; everything here has internal linkage, one
// copy per library.

#pragma once

#include <cuda_runtime.h>
#include <math.h>

#include "persistent.cuh"

namespace {

constexpr float kPi = 3.14159265358979f;
constexpr float kTwoPi = 6.28318530717959f;

// ---------------------------------------------------------------------------
// 3-vectors and row-major 3x3 blocks in registers
// ---------------------------------------------------------------------------

struct V3 { float v[3]; };
struct M3 { float m[9]; };

__device__ __forceinline__ V3 ld3(const float* a, long long i) {
  return V3{{a[3 * i], a[3 * i + 1], a[3 * i + 2]}};
}
__device__ __forceinline__ void st3(float* a, long long i, const V3& x) {
  a[3 * i] = x.v[0]; a[3 * i + 1] = x.v[1]; a[3 * i + 2] = x.v[2];
}
__device__ __forceinline__ M3 ld9(const float* a, long long i) {
  M3 r;
#pragma unroll
  for (int e = 0; e < 9; ++e) r.m[e] = a[9 * i + e];
  return r;
}
__device__ __forceinline__ void st9(float* a, long long i, const M3& x) {
#pragma unroll
  for (int e = 0; e < 9; ++e) a[9 * i + e] = x.m[e];
}
__device__ __forceinline__ V3 v3zero() { return V3{{0.f, 0.f, 0.f}}; }
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
__device__ __forceinline__ V3 mTvec(const M3& A, const V3& x) {
  V3 r;
#pragma unroll
  for (int a = 0; a < 3; ++a)
    r.v[a] = A.m[a] * x.v[0] + A.m[3 + a] * x.v[1] + A.m[6 + a] * x.v[2];
  return r;
}
__device__ __forceinline__ void madd(M3& A, const M3& B) {
#pragma unroll
  for (int e = 0; e < 9; ++e) A.m[e] += B.m[e];
}
__device__ __forceinline__ void vadd(V3& a, const V3& b) {
#pragma unroll
  for (int i = 0; i < 3; ++i) a.v[i] += b.v[i];
}
__device__ __forceinline__ float vdot(const V3& a, const V3& b) {
  return a.v[0] * b.v[0] + a.v[1] * b.v[1] + a.v[2] * b.v[2];
}

// ---------------------------------------------------------------------------
// SE(2) in the TPU kernel's form (gn_kernel.py:72-185)
// ---------------------------------------------------------------------------

__device__ __forceinline__ float wrapf(float x) {
  return x - kTwoPi * floorf((x + kPi) / kTwoPi);
}

__device__ V3 se2_between(const V3& a, const V3& b) {
  const float c = cosf(a.v[2]), s = sinf(a.v[2]);
  const float dx = b.v[0] - a.v[0], dy = b.v[1] - a.v[1];
  return V3{{c * dx + s * dy, -s * dx + c * dy, wrapf(b.v[2] - a.v[2])}};
}

__device__ V3 se2_log(const V3& p) {
  const float w = wrapf(p.v[2]);
  const bool small = fabsf(w) < 1e-6f;
  const float halfs = (small ? 1.f : w) / 2.f;
  const float A = small ? 1.f - w * w / 12.f : halfs * cosf(halfs) / sinf(halfs);
  const float half = w / 2.f;
  return V3{{A * p.v[0] + half * p.v[1], -half * p.v[0] + A * p.v[1], w}};
}

// Inverse left Jacobian at (vx, vy, w); the right one is Jl^{-1}(-xi).
__device__ M3 se2_jl_inv(float vx, float vy, float w) {
  const bool small = fabsf(w) < 1e-4f;
  const float ws = small ? 1.f : w;
  const float half = ws / 2.f;
  const float sw = sinf(ws), cw = cosf(ws), sh = sinf(half);
  const float a = small ? 1.f - w * w / 6.f : sw / ws;
  const float b = small ? w / 2.f - w * w * w / 24.f : 2.f * sh * sh / ws;
  const float da = small ? -w / 3.f + w * w * w / 30.f : (ws * cw - sw) / (ws * ws);
  const float db = small ? 0.5f - w * w / 8.f : (ws * sw - 2.f * sh * sh) / (ws * ws);
  const float Vv_x = a * vx - b * vy, Vv_y = b * vx + a * vy;
  const float dVv_x = da * vx - db * vy, dVv_y = db * vx + da * vy;
  const float D_x = dVv_x + Vv_y, D_y = dVv_y - Vv_x;
  const float A = small ? 1.f - w * w / 12.f : half * cosf(half) / sinf(half);
  const float B = w / 2.f;
  const float E_x = -(A * D_x + B * D_y);
  const float E_y = -(-B * D_x + A * D_y);
  return M3{{A, B, E_x, -B, A, E_y, 0.f, 0.f, 1.f}};
}

__device__ __forceinline__ M3 se2_jr_inv(const V3& r) {
  return se2_jl_inv(-r.v[0], -r.v[1], -r.v[2]);
}

__device__ M3 se2_adjoint(const V3& p) {
  const float c = cosf(p.v[2]), s = sinf(p.v[2]);
  return M3{{c, -s, p.v[1], s, c, -p.v[0], 0.f, 0.f, 1.f}};
}

__device__ V3 se2_inverse(const V3& p) {
  const float c = cosf(p.v[2]), s = sinf(p.v[2]);
  return V3{{-(c * p.v[0] + s * p.v[1]), -(-s * p.v[0] + c * p.v[1]), -p.v[2]}};
}

// Whitened between factor (gn_kernel.py:187-214): rw, Jiw, Jjw.
__device__ void linearize_edge(const V3& xi, const V3& xj, const V3& z, const M3& R,
                               float huber_delta, V3& rw, M3& Jiw, M3& Jjw) {
  const V3 h = se2_between(xi, xj);
  const V3 r = se2_log(se2_between(z, h));
  const M3 Jr_inv = se2_jr_inv(r);
  M3 Ji = mmul(Jr_inv, se2_adjoint(se2_inverse(h)));
#pragma unroll
  for (int e = 0; e < 9; ++e) Ji.m[e] = -Ji.m[e];
  rw = mvec(R, r);
  Jiw = mmul(R, Ji);
  Jjw = mmul(R, Jr_inv);
  if (huber_delta > 0.f) {
    const float n = sqrtf(fmaxf(vdot(rw, rw), 1e-24f));
    const float sw = sqrtf(fminf(1.f, huber_delta / n));
#pragma unroll
    for (int i = 0; i < 3; ++i) rw.v[i] *= sw;
#pragma unroll
    for (int e = 0; e < 9; ++e) {
      Jiw.m[e] *= sw;
      Jjw.m[e] *= sw;
    }
  }
}

// PCR ridge and inverse of the TPU kernel (gn_kernel.py:282-300).
__device__ __forceinline__ M3 ridge(M3 D, float eps3) {
  const float r = eps3 * fabsf(D.m[0] + D.m[4] + D.m[8]) + 1e-8f;
  D.m[0] += r;
  D.m[4] += r;
  D.m[8] += r;
  return D;
}

// Row a of the inverse is adj row a times 1/det_a, det_a = sum_s M[a,s]
// adj[a,s] (s = a, a+1, a+2), with |det| clamped to 1e-20 as on the TPU.
__device__ M3 binv(const M3& M) {
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

// Chain sub-diagonal L[m] = U[m-1]^T at level 0; the level's own L after.
__device__ __forceinline__ M3 load_L(const float* Ls, const float* U0, int m) {
  if (Ls) return ld9(Ls, m);
  return m >= 1 ? mT(ld9(U0, m - 1)) : m3zero();
}

// One PCR level at row n (gn_kernel.py:340-368): with h = 2^k,
//   alpha = L[n] Dinv[n-h], gamma = U[n] Dinv[n+h]   (zero off the ends)
//   D' = D - alpha U[n-h] - gamma L[n+h], L' = -alpha L[n-h], U' = -gamma U[n+h]
// where D is the ridged block and L at level 0 is U0[n-1]^T. The row
// inverts its neighbours' blocks itself, so one launch per level suffices.
// Writes alpha and gamma to A and G at (k, n); the last level writes the
// final inverse to Dinv instead of D', L', U'.
__device__ __forceinline__ void pcr_factor_row(int n, int N, int k, float eps, const float* Ds,
                                               const float* Us, const float* Ls, const float* U0,
                                               float* A, float* G, float* Dinv, float* Dd,
                                               float* Ud, float* Ld, int last) {
  const int h = 1 << k;
  const float eps3 = eps / 3.f;
  const bool has_m = n - h >= 0, has_p = n + h < N;
  const M3 Dn = ridge(ld9(Ds, n), eps3);
  const M3 Ln = load_L(Ls, U0, n);
  const M3 Un = ld9(Us, n);
  const M3 alpha = has_m ? mmul(Ln, binv(ridge(ld9(Ds, n - h), eps3))) : m3zero();
  const M3 gamma = has_p ? mmul(Un, binv(ridge(ld9(Ds, n + h), eps3))) : m3zero();
  const long long kn = (long long)k * N + n;
  st9(A, kn, alpha);
  st9(G, kn, gamma);
  const M3 aU = has_m ? mmul(alpha, ld9(Us, n - h)) : m3zero();
  const M3 gL = has_p ? mmul(gamma, load_L(Ls, U0, n + h)) : m3zero();
  M3 Dnew;
#pragma unroll
  for (int e = 0; e < 9; ++e) Dnew.m[e] = (Dn.m[e] - aU.m[e]) - gL.m[e];
  if (last) {
    st9(Dinv, n, binv(ridge(Dnew, eps3)));
    return;
  }
  M3 Lnew = has_m ? mmul(alpha, load_L(Ls, U0, n - h)) : m3zero();
  M3 Unew = has_p ? mmul(gamma, ld9(Us, n + h)) : m3zero();
#pragma unroll
  for (int e = 0; e < 9; ++e) {
    Lnew.m[e] = -Lnew.m[e];
    Unew.m[e] = -Unew.m[e];
  }
  st9(Dd, n, Dnew);
  st9(Ld, n, Lnew);
  st9(Ud, n, Unew);
}

// One PCR apply level at row n (gn_kernel.py:371-389): out[n] = b[n] - A[k]
// b[n-h] - G[k] b[n+h], times Dinv[n] at the last level; returns out[n].
__device__ __forceinline__ V3 pcr_apply_row(int n, int N, int k, const float* A, const float* G,
                                            const float* Dinv, const float* in, float* out,
                                            int last) {
  const int h = 1 << k;
  const long long kn = (long long)k * N + n;
  const V3 bn = ld3(in, n);
  const V3 am = n - h >= 0 ? mvec(ld9(A, kn), ld3(in, n - h)) : v3zero();
  const V3 gp = n + h < N ? mvec(ld9(G, kn), ld3(in, n + h)) : v3zero();
  V3 o;
#pragma unroll
  for (int a = 0; a < 3; ++a) o.v[a] = (bn.v[a] - am.v[a]) - gp.v[a];
  if (last) o = mvec(ld9(Dinv, n), o);
  st3(out, n, o);
  return o;
}

// ---------------------------------------------------------------------------
// The PCR levels as persistent stages (persistent.cuh)
// ---------------------------------------------------------------------------

// The K PCR factor levels of k_pcr_factor / cg_pcr_factor, a barrier after
// each: level 0 reads D and U (L from U), later levels the ping-pong
// buffers (PD, PU, PL)[(k - 1) & 1] and write [k & 1]; the last writes
// Dinv.
__device__ __forceinline__ void pcr_factor_stages(int N, int K, float eps, const float* D,
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
    for_rows(N, [&](int n) {
      pcr_factor_row(n, N, k, eps, Ds, Us, Ls, U, A, G, Dinv, Dd, Ud, Ld, last);
    });
    cluster_sync();
  }
}

// The K PCR apply levels of k_pcr_apply / cg_pcr_apply, a barrier after
// each: in -> t0 -> t1 -> t0 ... -> out, the last level times Dinv and the
// block partials of rdot.out written to part.
__device__ __forceinline__ void pcr_apply_stages(int N, int K, const float* A, const float* G,
                                                 const float* Dinv, const float* in, float* t0,
                                                 float* t1, float* out, const float* rdot,
                                                 float* part) {
  const float* src = in;
  for (int k = 0; k < K; ++k) {
    if (k == K - 1) {
      for_rows_sum(N, part, [&](int n) {
        const V3 o = pcr_apply_row(n, N, k, A, G, Dinv, src, out, 1);
        return vdot(ld3(rdot, n), o);
      });
    } else {
      float* dst = k & 1 ? t1 : t0;
      for_rows(N, [&](int n) { pcr_apply_row(n, N, k, A, G, Dinv, src, dst, 0); });
      src = dst;
    }
    cluster_sync();
  }
}

}  // namespace
