// K4 normal_system — the robust Gauss-Newton normal system of the
// point-to-plane correspondences at the current pose.
//
// Replaces: the plane part of superodom_tpu/registration.py
// _accumulate_normal_system (:484-491) with _tukey_weight (:455-460).
// Plain version: registration.normal_system_reference.  The pose-prior
// diagonal, the damped 6x6 solve, the axis hold and the retraction stay in
// PyTorch.
//
// Per correspondence m: wp = R p + t, residual r = n.wp + d, Jacobian
// J = [n, wp x n], weight w = valid * coeff * Tukey(r^2; a_sq) with
// Tukey = (1 - r^2/a_sq)^2 inside the support and 0 outside.  Output: the
// 21 upper-triangle entries of H = sum w J J^T (row-major), g = sum w J r
// and cost = sum w r^2 — 28 floats.
//
// What bounds it on an H100: launch latency.  At M = 2,048 the kernel
// reads ~57 KB and does ~150 flops a correspondence; both are far below a
// microsecond of the card.  Design: ONE block of 256 threads; each thread
// accumulates a fixed strided subset in a fixed order, then a fixed-order
// shared-memory tree reduction — no float atomics, so repeated runs on the
// card give identical sums (the GN iterate is reproducible bit for bit).
#include "common.cuh"

#define NS_THREADS 256
#define NS_OUT 28

__global__ void __launch_bounds__(NS_THREADS) normal_system_kernel(
    const float* __restrict__ p_body, const float* __restrict__ normal,
    const float* __restrict__ dd, const float* __restrict__ coeff,
    const unsigned char* __restrict__ valid, int nm,
    const float* __restrict__ pose_q, const float* __restrict__ pose_t,
    const float* __restrict__ a_sq_p, float* __restrict__ out) {
  __shared__ float sh[NS_OUT][NS_THREADS];
  const int tid = threadIdx.x;
  const float q[4] = {pose_q[0], pose_q[1], pose_q[2], pose_q[3]};
  const float t[3] = {pose_t[0], pose_t[1], pose_t[2]};
  const float a_sq = fmaxf(a_sq_p[0], 1e-12f);

  float acc[NS_OUT];
#pragma unroll
  for (int v = 0; v < NS_OUT; ++v) acc[v] = 0.0f;

  for (int m = tid; m < nm; m += NS_THREADS) {
    const float p[3] = {p_body[m * 3 + 0], p_body[m * 3 + 1],
                        p_body[m * 3 + 2]};
    const float n[3] = {normal[m * 3 + 0], normal[m * 3 + 1],
                        normal[m * 3 + 2]};
    float wp[3];
    so_quat_rotate(q, p, wp);
    wp[0] += t[0];
    wp[1] += t[1];
    wp[2] += t[2];
    const float r = so_dot3(n, wp) + dd[m];
    float J[6] = {n[0], n[1], n[2], 0.0f, 0.0f, 0.0f};
    so_cross(wp, n, J + 3);
    const float ratio = (r * r) / a_sq;
    const float tk = ratio < 1.0f ? (1.0f - ratio) * (1.0f - ratio) : 0.0f;
    const float w = (valid[m] ? 1.0f : 0.0f) * coeff[m] * tk;
    int v = 0;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float wj = w * J[i];
#pragma unroll
      for (int j = i; j < 6; ++j) acc[v++] += wj * J[j];
    }
#pragma unroll
    for (int i = 0; i < 6; ++i) acc[21 + i] += (w * J[i]) * r;
    acc[27] += (w * r) * r;
  }
#pragma unroll
  for (int v = 0; v < NS_OUT; ++v) sh[v][tid] = acc[v];
  __syncthreads();
  for (int s = NS_THREADS / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int v = 0; v < NS_OUT; ++v) sh[v][tid] += sh[v][tid + s];
    }
    __syncthreads();
  }
  if (tid < NS_OUT) out[tid] = sh[tid][0];
}

extern "C" int so_normal_system(const float* p_body, const float* normal,
                                const float* d, const float* coeff,
                                const unsigned char* valid, int nm,
                                const float* pose_q, const float* pose_t,
                                const float* a_sq, float* out, void* stream) {
  normal_system_kernel<<<1, NS_THREADS, 0, (cudaStream_t)stream>>>(
      p_body, normal, d, coeff, valid, nm, pose_q, pose_t, a_sq, out);
  return (int)cudaGetLastError();
}
