// K3 plane_fit — PCA plane fit, gates, rejection code and observability
// bins of every point-to-plane correspondence.
//
// Replaces: superodom_tpu/registration.py _plane_fit (:212-280) +
// _weighted_pca (:145-154) + _observability_bins (:283-315) and
// superodom_tpu/ops/eigh3.py eigh3 (:21-110).  Plain version:
// registration.plane_fit_reference.
//
// Per correspondence, over its k selected neighbours (valid ones weighted
// 1, the rest 0): the mean and the unnormalised 3x3 scatter, its
// closed-form trigonometric eigendecomposition with eigh3's fallbacks
// (only the eigenvalues and the smallest eigenvector are needed), then the
// reference's gates in its order — enough neighbours, k-th distance within
// 3*res, PCA planarity, finite normal, every neighbour within res/2 of the
// plane — the normal with d > 0, the fit-quality coefficient and the
// top-2 rotation / top-1 translation observability bins.
//
// What bounds it on an H100: neither arithmetic (~400 flops a query) nor
// bytes (~120 bytes in, ~40 out a query) at Q = 2,048 — it is one short
// launch.  Design: one thread per correspondence, everything in registers,
// written op for op as the plain version so the two agree to rounding.
#include <math.h>

#include "common.cuh"

#define PF_MAX_K 16

static __device__ __forceinline__ float so_sq(float x) { return x * x; }

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
  float n[3];
  for (int i = 0; i < 3; ++i) n[i] = so_dot3(c[i], c[i]);
  int best = 0;
  for (int i = 1; i < 3; ++i)
    if (n[i] > n[best]) best = i;
  // a NaN norm takes the fallback, as jnp.max / torch.amax propagate it
  const bool any_nan = isnan(n[0]) || isnan(n[1]) || isnan(n[2]);
  const float nmax = fmaxf(fmaxf(n[0], n[1]), n[2]);
  if (!any_nan && nmax > 1e-12f) {
    v[0] = c[best][0];
    v[1] = c[best][1];
    v[2] = c[best][2];
  } else {
    v[0] = 1.0f;
    v[1] = 0.0f;
    v[2] = 0.0f;
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

static __device__ __forceinline__ int so_argmax(const float* v, int n) {
  int best = 0;
  for (int i = 1; i < n; ++i)
    if (v[i] > v[best]) best = i;
  return best;
}

__global__ void plane_fit_kernel(
    const float* __restrict__ neigh, const float* __restrict__ sq,
    const unsigned char* __restrict__ nvalid,
    const unsigned char* __restrict__ mask, const float* __restrict__ w_pt,
    const float* __restrict__ pose_q, const float* __restrict__ plane_res_p,
    int nq, int k, float* __restrict__ normal_out, float* __restrict__ d_out,
    float* __restrict__ coeff_out, unsigned char* __restrict__ valid_out,
    int* __restrict__ code_out, int* __restrict__ bins_out) {
  const int m = blockIdx.x * blockDim.x + threadIdx.x;
  if (m >= nq) return;
  const float plane_res = plane_res_p[0];
  const float* P = neigh + (size_t)m * k * 3;

  float w[PF_MAX_K];
  int n_found = 0;
  float wsum = 0.0f;
  for (int j = 0; j < k; ++j) {
    w[j] = nvalid[(size_t)m * k + j] ? 1.0f : 0.0f;
    n_found += nvalid[(size_t)m * k + j] ? 1 : 0;
    wsum += w[j];
  }
  const bool enough = n_found >= k;
  const float max_sq = 3.0f * plane_res;
  const bool near = enough && sq[(size_t)m * k + k - 1] <= max_sq;

  // weighted mean + unnormalised scatter (_weighted_pca)
  wsum = fmaxf(wsum, 1e-6f);
  float mean[3];
  for (int a = 0; a < 3; ++a) {
    float s = 0.0f;
    for (int j = 0; j < k; ++j) s += P[j * 3 + a] * w[j];
    mean[a] = s / wsum;
  }
  float cov[3][3] = {{0.0f}};
  for (int j = 0; j < k; ++j) {
    float c[3];
    for (int a = 0; a < 3; ++a) c[a] = (P[j * 3 + a] - mean[a]) * w[j];
    for (int a = 0; a < 3; ++a)
      for (int b = 0; b < 3; ++b) cov[a][b] += c[a] * c[b];
  }
  float ev[3], v_lo[3];
  so_eigvals3(cov, ev);
  so_eigvec(cov, ev[0], v_lo);

  const bool pca_ok = ev[0] >= 1e-6f && ev[1] / fmaxf(ev[2], 1e-12f) >= 0.1f;

  float n[3] = {v_lo[0], v_lo[1], v_lo[2]};
  float d = -so_dot3(n, mean);
  if (d < 0.0f) {
    n[0] = -n[0];
    n[1] = -n[1];
    n[2] = -n[2];
  }
  d = fabsf(d);
  const bool numeric_ok =
      isfinite(n[0]) && isfinite(n[1]) && isfinite(n[2]) && isfinite(d);

  bool mse_ok = true;
  float dist_sum = 0.0f;
  for (int j = 0; j < k; ++j) {
    const float pd = fabsf(so_dot3(P + j * 3, n) + d);
    if (w[j] != 0.0f) {
      mse_ok = mse_ok && pd <= plane_res / 2.0f;
      dist_sum += pd;
    }
  }
  const float mean_dist = dist_sum / fmaxf((float)n_found, 1.0f);
  const float coeff =
      1.0f - sqrtf(fminf(fmaxf(mean_dist / max_sq, 0.0f), 1.0f));
  const bool mk = mask[m] != 0;
  const bool valid = mk && enough && near && pca_ok && numeric_ok && mse_ok;

  int code = 0;
  if (!mse_ok) code = 5;
  if (!numeric_ok) code = 4;
  if (!pca_ok) code = 3;
  if (!near) code = 2;
  if (!enough) code = 1;
  if (!mk) code = 6;

  // observability bins (_observability_bins): unflipped smallest
  // eigenvector, oriented toward the viewpoint
  const float lam1 = sqrtf(fmaxf(ev[2], 0.0f));
  const float lam2 = sqrtf(fmaxf(ev[1], 0.0f));
  const float lam3 = sqrtf(fmaxf(ev[0], 0.0f));
  const float planar2 = (lam2 - lam3) / fmaxf(lam1, 1e-12f);
  const float* wp = w_pt + (size_t)m * 3;
  float on[3] = {v_lo[0], v_lo[1], v_lo[2]};
  if (so_dot3(wp, on) < 0.0f) {
    on[0] = -on[0];
    on[1] = -on[1];
    on[2] = -on[2];
  }
  const float q[4] = {pose_q[0], pose_q[1], pose_q[2], pose_q[3]};
  float axes[3][3];
  for (int i = 0; i < 3; ++i) {
    const float e[3] = {i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f,
                        i == 2 ? 1.0f : 0.0f};
    so_quat_rotate(q, e, axes[i]);
  }
  const float wpv[3] = {wp[0], wp[1], wp[2]};
  float cr[3];
  so_cross(wpv, on, cr);
  const float rx = so_dot3(cr, axes[0]), ry = so_dot3(cr, axes[1]),
              rz = so_dot3(cr, axes[2]);
  float rot[6] = {rx, -rx, ry, -ry, rz, -rz};
  const float p2 = planar2 * planar2;
  const float tq[3] = {p2 * fabsf(so_dot3(on, axes[0])),
                       p2 * fabsf(so_dot3(on, axes[1])),
                       p2 * fabsf(so_dot3(on, axes[2]))};
  const int top1 = so_argmax(rot, 6);
  rot[top1] = -INFINITY;
  const int top2 = so_argmax(rot, 6);
  const int ttop = so_argmax(tq, 3) + 6;

  normal_out[m * 3 + 0] = n[0];
  normal_out[m * 3 + 1] = n[1];
  normal_out[m * 3 + 2] = n[2];
  d_out[m] = d;
  coeff_out[m] = valid ? coeff : 0.0f;
  valid_out[m] = valid;
  code_out[m] = code;
  bins_out[m * 3 + 0] = valid ? top1 : -1;
  bins_out[m * 3 + 1] = valid ? top2 : -1;
  bins_out[m * 3 + 2] = valid ? ttop : -1;
}

extern "C" int so_plane_fit(const float* neigh, const float* sq,
                            const unsigned char* nvalid,
                            const unsigned char* mask, const float* w_pt,
                            const float* pose_q, const float* plane_res,
                            int nq, int k, float* normal, float* d,
                            float* coeff, unsigned char* valid, int* code,
                            int* bins, void* stream) {
  if (k > PF_MAX_K) return (int)cudaErrorInvalidValue;
  if (nq > 0) {
    const int threads = 128;
    const int blocks = (nq + threads - 1) / threads;
    plane_fit_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        neigh, sq, nvalid, mask, w_pt, pose_q, plane_res, nq, k, normal, d,
        coeff, valid, code, bins);
  }
  return (int)cudaGetLastError();
}
