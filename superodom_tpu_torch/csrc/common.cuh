// Shared helpers of the hand-written kernels (superodom_tpu_torch/csrc).
//
// Build: nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3
//        --fmad=false -shared -Xcompiler -fPIC  (see kernels.py).
// --fmad=false keeps every multiply and add separately rounded, as
// PyTorch's eager elementwise ops are, so a kernel and its plain PyTorch
// version agree to the bit wherever they sum in the same order.
//
// Every entry point has a plain C interface: device pointers, sizes, the
// CUDA stream; it launches, does not synchronise, allocates nothing, and
// returns cudaGetLastError() so the Python wrapper can raise on a refused
// launch.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

#define SO_BIG 1e30f

// v' = v + 2*(w*(u x v) + u x (u x v)) — geometry.quat_rotate, op for op
static __device__ __forceinline__ void so_quat_rotate(const float q[4],
                                                      const float v[3],
                                                      float out[3]) {
  const float w = q[0], ux = q[1], uy = q[2], uz = q[3];
  const float c0 = uy * v[2] - uz * v[1];
  const float c1 = uz * v[0] - ux * v[2];
  const float c2 = ux * v[1] - uy * v[0];
  const float d0 = uy * c2 - uz * c1;
  const float d1 = uz * c0 - ux * c2;
  const float d2 = ux * c1 - uy * c0;
  out[0] = v[0] + 2.0f * (w * c0 + d0);
  out[1] = v[1] + 2.0f * (w * c1 + d1);
  out[2] = v[2] + 2.0f * (w * c2 + d2);
}

// a x b
static __device__ __forceinline__ void so_cross(const float a[3],
                                                const float b[3],
                                                float out[3]) {
  out[0] = a[1] * b[2] - a[2] * b[1];
  out[1] = a[2] * b[0] - a[0] * b[2];
  out[2] = a[0] * b[1] - a[1] * b[0];
}

// (a0*b0 + a1*b1) + a2*b2
static __device__ __forceinline__ float so_dot3(const float a[3],
                                                const float b[3]) {
  return a[0] * b[0] + a[1] * b[1] + a[2] * b[2];
}
