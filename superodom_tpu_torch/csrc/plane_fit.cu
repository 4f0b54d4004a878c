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
// launch, and what costs is one round trip to memory, then the serial chain
// of one thread (IEEE divisions, roots, acosf, cosf), then the stores.
// Design:
//   * one thread per correspondence, written op for op as the plain
//     version, every sum in index order in that one thread, so the two
//     agree to the bit;
//   * k is a template parameter for the presets' 5 and for 10: the row,
//     the weights and the scatter sit in registers, every loop unrolls and
//     nothing is indexed by a runtime value (no local memory), and one
//     read of the row serves the mean, the scatter and the residuals; any
//     other k <= 16 takes the runtime-k instance, which re-reads the row
//     where it is used;
//   * every load of a thread (row, validity, k-th distance, point, mask,
//     pose, resolution) is made at the top, before the first use, so the
//     thread waits for memory once;
//   * blocks of PF_BLOCK = 64 correspondences: the main path's 2,048 rows
//     are 32 blocks of 2 warps.
// Measured on the H100 and not kept, because none was faster here (the
// 276 KB of inputs are in L2, written by K2 just before; PERF.md): staging
// each block's contiguous tile in shared memory with 16-byte asynchronous
// copies, coalesced stores of normal and bins through shared memory, and
// the body axes computed once a block into shared memory (each costs a
// block barrier).
//
// Instances: one launch serves n_inst independent solves (the batched step
// of superodom_tpu_torch/parallel.py).  Instance i is blockIdx.y: its
// inputs (neighbourhoods, distances, validity, mask, points, pose, plane
// resolution) start istride[0..6] elements after instance 0's (0:
// shared), its outputs follow at i * Q (times 3 for normal and bins).
// Each instance computes exactly what a launch on its own inputs computes,
// and n_inst = 1 is the single launch.
#include <math.h>

#include "common.cuh"
#include "eigh3.cuh"

#define PF_MAX_K 16
// correspondences (= threads) a block; 32, 128 and 256 measured no faster
// on the H100 (PERF.md)
#define PF_BLOCK 64

// the instance strides of the seven inputs, in elements
struct PfStrides {
  long long s[7];
};

// K > 0: k known when compiled; K == 0: any k <= PF_MAX_K, given as k_rt.
template <int K>
__global__ void __launch_bounds__(PF_BLOCK) plane_fit_kernel(
    const float* __restrict__ neigh, const float* __restrict__ sq,
    const unsigned char* __restrict__ nvalid,
    const unsigned char* __restrict__ mask, const float* __restrict__ w_pt,
    const float* __restrict__ pose_q, const float* __restrict__ plane_res_p,
    int nq, int k_rt, float* __restrict__ normal_out,
    float* __restrict__ d_out, float* __restrict__ coeff_out,
    unsigned char* __restrict__ valid_out, int* __restrict__ code_out,
    int* __restrict__ bins_out, PfStrides is) {
  {
    const unsigned i = blockIdx.y;
    const size_t o = (size_t)i * nq;
    neigh += i * is.s[0];
    sq += i * is.s[1];
    nvalid += i * is.s[2];
    mask += i * is.s[3];
    w_pt += i * is.s[4];
    pose_q += i * is.s[5];
    plane_res_p += i * is.s[6];
    normal_out += 3 * o;
    d_out += o;
    coeff_out += o;
    valid_out += o;
    code_out += o;
    bins_out += 3 * o;
  }
  const int k = K > 0 ? K : k_rt;
  const int m = (int)(blockIdx.x * PF_BLOCK + threadIdx.x);
  if (m >= nq) return;
  const float* row = neigh + (size_t)m * k * 3;
  const unsigned char* nv = nvalid + (size_t)m * k;

  // every load of the thread is made here, before any use: one round trip
  // to memory.  The row and its weights sit in registers where k is known
  // (one read serves the mean, the scatter and the residuals); the
  // runtime-k instance reads them where they are used.
  float P[K > 0 ? K * 3 : 1], w[K > 0 ? K : 1];
  if constexpr (K > 0) {
#pragma unroll
    for (int j = 0; j < K; ++j) {
      w[j] = nv[j] ? 1.0f : 0.0f;
#pragma unroll
      for (int a = 0; a < 3; ++a) P[j * 3 + a] = row[j * 3 + a];
    }
  }
  const float sq_last = sq[(size_t)m * k + k - 1];
  const float wpv[3] = {w_pt[(size_t)m * 3], w_pt[(size_t)m * 3 + 1],
                        w_pt[(size_t)m * 3 + 2]};
  const bool mk = mask[m] != 0;
  const float plane_res = plane_res_p[0];
  const float q[4] = {pose_q[0], pose_q[1], pose_q[2], pose_q[3]};

  auto pt = [&](int j, int a) -> float {
    if constexpr (K > 0) return P[j * 3 + a];
    else return row[j * 3 + a];
  };
  auto wt = [&](int j) -> float {
    if constexpr (K > 0) return w[j];
    else return nv[j] ? 1.0f : 0.0f;
  };

  int n_found = 0;
  float wsum = 0.0f;
#pragma unroll
  for (int j = 0; j < k; ++j) {
    n_found += wt(j) != 0.0f ? 1 : 0;
    wsum += wt(j);
  }
  const bool enough = n_found >= k;
  const float max_sq = 3.0f * plane_res;
  const bool near = enough && sq_last <= max_sq;

  // weighted mean + unnormalised scatter (_weighted_pca)
  wsum = fmaxf(wsum, 1e-6f);
  float mean[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < k; ++j) s += pt(j, a) * wt(j);
    mean[a] = s / wsum;
  }
  float cov[3][3] = {{0.0f}};
#pragma unroll
  for (int j = 0; j < k; ++j) {
    float c[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) c[a] = (pt(j, a) - mean[a]) * wt(j);
#pragma unroll
    for (int a = 0; a < 3; ++a)
#pragma unroll
      for (int b = 0; b < 3; ++b) cov[a][b] += c[a] * c[b];
  }
  float ev[3], v_lo[3];
  so_eigvals3(cov, ev);
  so_eigvec(cov, ev[0], v_lo);

  const bool pca_ok =
      ev[0] >= 1e-6f && ev[1] / fmaxf(ev[2], 1e-12f) >= 0.1f;

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
#pragma unroll
  for (int j = 0; j < k; ++j) {
    const float pj[3] = {pt(j, 0), pt(j, 1), pt(j, 2)};
    const float pd = fabsf(so_dot3(pj, n) + d);
    if (wt(j) != 0.0f) {
      mse_ok = mse_ok && pd <= plane_res / 2.0f;
      dist_sum += pd;
    }
  }
  const float mean_dist = dist_sum / fmaxf((float)n_found, 1.0f);
  const float coeff =
      1.0f - sqrtf(fminf(fmaxf(mean_dist / max_sq, 0.0f), 1.0f));
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
  float on[3] = {v_lo[0], v_lo[1], v_lo[2]};
  if (so_dot3(wpv, on) < 0.0f) {
    on[0] = -on[0];
    on[1] = -on[1];
    on[2] = -on[2];
  }
  float axes[3][3];  // the body axes in the world frame
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float e[3] = {i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f,
                        i == 2 ? 1.0f : 0.0f};
    so_quat_rotate(q, e, axes[i]);
  }
  float cr[3];
  so_cross(wpv, on, cr);
  const float rx = so_dot3(cr, axes[0]), ry = so_dot3(cr, axes[1]),
              rz = so_dot3(cr, axes[2]);
  float rot[6] = {rx, -rx, ry, -ry, rz, -rz};
  const float p2 = planar2 * planar2;
  const float tq[3] = {p2 * fabsf(so_dot3(on, axes[0])),
                       p2 * fabsf(so_dot3(on, axes[1])),
                       p2 * fabsf(so_dot3(on, axes[2]))};
  const int top1 = so_argmax<6>(rot);
#pragma unroll
  for (int i = 0; i < 6; ++i)
    if (i == top1) rot[i] = -INFINITY;
  const int top2 = so_argmax<6>(rot);
  const int ttop = so_argmax<3>(tq) + 6;

  normal_out[(size_t)m * 3 + 0] = n[0];
  normal_out[(size_t)m * 3 + 1] = n[1];
  normal_out[(size_t)m * 3 + 2] = n[2];
  bins_out[(size_t)m * 3 + 0] = valid ? top1 : -1;
  bins_out[(size_t)m * 3 + 1] = valid ? top2 : -1;
  bins_out[(size_t)m * 3 + 2] = valid ? ttop : -1;
  d_out[m] = d;
  coeff_out[m] = valid ? coeff : 0.0f;
  valid_out[m] = valid;
  code_out[m] = code;
}

template <int K>
static void so_launch_plane_fit(
    const float* neigh, const float* sq, const unsigned char* nvalid,
    const unsigned char* mask, const float* w_pt, const float* pose_q,
    const float* plane_res, int nq, int k, float* normal, float* d,
    float* coeff, unsigned char* valid, int* code, int* bins, int n_inst,
    const PfStrides& is, cudaStream_t stream) {
  const dim3 blocks((unsigned)((nq + PF_BLOCK - 1) / PF_BLOCK),
                    (unsigned)n_inst);
  plane_fit_kernel<K><<<blocks, PF_BLOCK, 0, stream>>>(
      neigh, sq, nvalid, mask, w_pt, pose_q, plane_res, nq, k, normal, d,
      coeff, valid, code, bins, is);
}

// istride (host) = the instance strides, in elements, of neigh, sq,
// nvalid, mask, w_pt, pose_q and plane_res.
extern "C" int so_plane_fit(const float* neigh, const float* sq,
                            const unsigned char* nvalid,
                            const unsigned char* mask, const float* w_pt,
                            const float* pose_q, const float* plane_res,
                            int nq, int k, float* normal, float* d,
                            float* coeff, unsigned char* valid, int* code,
                            int* bins, int n_inst, const long long* istride,
                            void* stream) {
  if (k < 1 || k > PF_MAX_K || n_inst < 1 || n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  PfStrides is;
  for (int i = 0; i < 7; ++i) is.s[i] = istride[i];
  if (nq > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
      case 5: so_launch_plane_fit<5>(neigh, sq, nvalid, mask, w_pt, pose_q, plane_res, nq, k, normal, d, coeff, valid, code, bins, n_inst, is, s); break;
      case 10: so_launch_plane_fit<10>(neigh, sq, nvalid, mask, w_pt, pose_q, plane_res, nq, k, normal, d, coeff, valid, code, bins, n_inst, is, s); break;
      default: so_launch_plane_fit<0>(neigh, sq, nvalid, mask, w_pt, pose_q, plane_res, nq, k, normal, d, coeff, valid, code, bins, n_inst, is, s); break;
    }
  }
  return (int)cudaGetLastError();
}
