// The closed-form symmetric 3x3 eigensolver of ops/eigh3.py, on the
// device, shared by K3 (csrc/plane_fit.cu) and K11b (csrc/edge_fit.cu).
//
// Replaces: superodom_tpu/ops/eigh3.py eigh3 (:21-110).  Written op for
// op as superodom_tpu_torch/ops/eigh3.py, so that a kernel built with
// --fmad=false and the plain version agree to the bit.
#pragma once

#include <math.h>

#include "common.cuh"

// ---------------------------------------------------------- eigensolver

static __device__ __forceinline__ float so_sq(float x) { return x * x; }

// first index of the largest value (strict >, the lower index wins a tie;
// a NaN never wins), without indexing by a runtime value, so v stays in
// registers
template <int N>
static __device__ __forceinline__ int so_argmax(const float (&v)[N]) {
  int best = 0;
  float top = v[0];
#pragma unroll
  for (int i = 1; i < N; ++i)
    if (v[i] > top) {
      top = v[i];
      best = i;
    }
  return best;
}

// row-cross-product eigenvector of A for eigenvalue lam (eigh3._eigvec)
static __device__ void so_eigvec(const float A[3][3], float lam,
                                 float v[3]) {
  float r0[3] = {A[0][0] - lam, A[0][1], A[0][2]};
  float r1[3] = {A[1][0], A[1][1] - lam, A[1][2]};
  float r2[3] = {A[2][0], A[2][1], A[2][2] - lam};
  float c[3][3];
  so_cross(r0, r1, c[0]);
  so_cross(r0, r2, c[1]);
  so_cross(r1, r2, c[2]);
  const float n[3] = {so_dot3(c[0], c[0]), so_dot3(c[1], c[1]),
                      so_dot3(c[2], c[2])};
  const int best = so_argmax<3>(n);
  // a NaN norm takes the fallback, as jnp.max / torch.amax propagate it
  const bool any_nan = isnan(n[0]) || isnan(n[1]) || isnan(n[2]);
  const float nmax = fmaxf(fmaxf(n[0], n[1]), n[2]);
  const bool use = !any_nan && nmax > 1e-12f;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float ca = best == 0 ? c[0][a] : best == 1 ? c[1][a] : c[2][a];
    v[a] = use ? ca : (a == 0 ? 1.0f : 0.0f);
  }
  const float nv = fmaxf(sqrtf(so_dot3(v, v)), 1e-20f);
  v[0] /= nv;
  v[1] /= nv;
  v[2] /= nv;
}

// eigenvalues ascending (eigh3._eigvals3)
static __device__ void so_eigvals3(const float A[3][3], float ev[3]) {
  const float a00 = A[0][0], a11 = A[1][1], a22 = A[2][2];
  const float a01 = A[0][1], a02 = A[0][2], a12 = A[1][2];
  const float p1 = a01 * a01 + a02 * a02 + a12 * a12;
  const float q = (a00 + a11 + a22) / 3.0f;
  const float p2 =
      so_sq(a00 - q) + so_sq(a11 - q) + so_sq(a22 - q) + 2.0f * p1;
  const float p = sqrtf(fmaxf(p2 / 6.0f, 0.0f));
  const float sp = fmaxf(p, 1e-12f);
  const float b00 = (a00 - q) / sp, b11 = (a11 - q) / sp,
              b22 = (a22 - q) / sp;
  const float b01 = a01 / sp, b02 = a02 / sp, b12 = a12 / sp;
  const float detB = b00 * (b11 * b22 - b12 * b12) -
                     b01 * (b01 * b22 - b12 * b02) +
                     b02 * (b01 * b12 - b11 * b02);
  const float r = fminf(fmaxf(detB / 2.0f, -1.0f), 1.0f);
  const float phi = acosf(r) / 3.0f;
  const float lmax = q + 2.0f * p * cosf(phi);
  const float lmin = q + 2.0f * p * cosf(phi + 2.0943951023931953f);
  const float lmid = 3.0f * q - lmax - lmin;
  if (p1 < 1e-12f) {  // near-diagonal: the sorted diagonal
    float s0 = a00, s1 = a11, s2 = a22, t;
    if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
    if (s1 > s2) { t = s1; s1 = s2; s2 = t; }
    if (s0 > s1) { t = s0; s0 = s1; s1 = t; }
    ev[0] = s0;
    ev[1] = s1;
    ev[2] = s2;
  } else {
    ev[0] = lmin;
    ev[1] = lmid;
    ev[2] = lmax;
  }
}

// the largest eigenvector as eigh3 gives it: the row-cross-product vector
// for lam_hi, unless it is (near-)parallel to v_lo (the isotropic case),
// then the unit vector orthogonal to v_lo of the larger cross with the x or
// the y axis
static __device__ void so_eigvec_hi(const float A[3][3], float lam_hi,
                                    const float v_lo[3], float v[3]) {
  so_eigvec(A, lam_hi, v);
  float c[3];
  so_cross(v, v_lo, c);
  const float c_n = so_dot3(c, c);
  const float ex[3] = {1.0f, 0.0f, 0.0f}, ey[3] = {0.0f, 1.0f, 0.0f};
  float alt1[3], alt2[3];
  so_cross(v_lo, ex, alt1);
  so_cross(v_lo, ey, alt2);
  const bool first = so_dot3(alt1, alt1) > so_dot3(alt2, alt2);
  float alt[3] = {first ? alt1[0] : alt2[0], first ? alt1[1] : alt2[1],
                  first ? alt1[2] : alt2[2]};
  const float na = so_clamp_min(sqrtf(so_dot3(alt, alt)), 1e-20f);
  alt[0] /= na;
  alt[1] /= na;
  alt[2] /= na;
  if (!(c_n > 1e-12f)) {
    v[0] = alt[0];
    v[1] = alt[1];
    v[2] = alt[2];
  }
}
