// K11a curvature_edges — LOAM-style edge detection: the local curvature of
// every lane along its scan line, thresholded into a keep-mask.
//
// Replaces: superodom_tpu/frontend.py curvature_edge_extraction
// (:307-342).  Plain version: frontend.curvature_edge_extraction_reference.
//
// Per lane i of N, over the offsets -w..-1, +1..+w in that order, with the
// neighbour j = (i + off) mod N (the rolls WRAP: the first w lanes see the
// last w and the reverse):
//   same_j = ring[j] == ring[i] && mask[j];
//   acc    = acc + (same_j ? xyz[j] - xyz[i] : 0)   (a sequential sum);
//   curv   = |acc| / (2w * max(|xyz[i]|, 1e-6));
//   edge   = mask[i] && every same_j && curv > threshold
//            && |xyz[i]| > min_range.
// Norms are sqrt((x*x + y*y) + z*z); with --fmad=false and IEEE division
// the mask is the plain version's to the bit.
//
// What bounds it on an H100: bytes, and at the main path's 131,072 lanes
// (~2.4 MB in, 131 KB out: ~0.7 us) the launch more than either.  Design:
// one thread a lane, CE_BLOCK lanes a block; the block's lanes and a halo
// of w on either side (wrapped mod N) are staged once in shared memory by
// coalesced loads, so each lane's 2w neighbour reads hit shared memory.
//
// Instances: one launch serves n_inst independent clouds of N lanes each
// (the batched step of superodom_tpu_torch/parallel.py).  Instance i is
// blockIdx.y: its points, rings and mask start istride[0..2] elements
// after instance 0's (0: shared), its mask out at i * N.  The halo wraps
// mod N inside the instance's own lanes, as jnp.roll does under jax.vmap:
// no lane reads a neighbouring instance.  n_inst = 1 is the single launch.
#include <math.h>

#include "common.cuh"

#define CE_BLOCK 256
#define CE_MAX_HW 16  // the largest half window the staged halo holds

// the instance strides of xyz, ring and mask, in elements
struct CeStrides {
  long long s[3];
};

__global__ void __launch_bounds__(CE_BLOCK) curvature_edges_kernel(
    const float* __restrict__ xyz, const int* __restrict__ ring,
    const unsigned char* __restrict__ mask, int n, int hw, float den_scale,
    float threshold, float min_range, unsigned char* __restrict__ out,
    CeStrides is) {
  {
    const unsigned b = blockIdx.y;
    xyz += b * is.s[0];
    ring += b * is.s[1];
    mask += b * is.s[2];
    out += (size_t)b * n;
  }
  __shared__ float sx[CE_BLOCK + 2 * CE_MAX_HW][3];
  __shared__ int sr[CE_BLOCK + 2 * CE_MAX_HW];
  __shared__ unsigned char sm[CE_BLOCK + 2 * CE_MAX_HW];

  const int base = (int)blockIdx.x * CE_BLOCK;
  const int span = min(CE_BLOCK, n - base) + 2 * hw;
  for (int s = threadIdx.x; s < span; s += CE_BLOCK) {
    const long long g = (long long)base - hw + s;
    const int j = (int)(((g % n) + n) % n);
    sx[s][0] = xyz[3 * (size_t)j];
    sx[s][1] = xyz[3 * (size_t)j + 1];
    sx[s][2] = xyz[3 * (size_t)j + 2];
    sr[s] = ring[j];
    sm[s] = mask[j];
  }
  __syncthreads();

  const int i = base + (int)threadIdx.x;
  if (i >= n) return;
  const int c = (int)threadIdx.x + hw;
  const float p[3] = {sx[c][0], sx[c][1], sx[c][2]};
  const int ri = sr[c];
  const float rng = sqrtf(so_dot3(p, p));
  float acc[3] = {0.0f, 0.0f, 0.0f};
  bool ok = true;
  for (int off = -hw; off <= hw; ++off) {
    if (off == 0) continue;
    const int s = c + off;
    const bool same = sr[s] == ri && sm[s] != 0;
#pragma unroll
    for (int a = 0; a < 3; ++a) acc[a] = acc[a] + (same ? sx[s][a] - p[a] : 0.0f);
    ok = ok && same;
  }
  const float curv =
      sqrtf(so_dot3(acc, acc)) / (den_scale * so_clamp_min(rng, 1e-6f));
  out[i] = (sm[c] != 0 && ok && curv > threshold && rng > min_range) ? 1 : 0;
}

// den_scale = 2 * half_window, rounded to float as the plain version's
// Python scalar is.  istride (host) = the instance strides, in elements,
// of xyz, ring and mask.
extern "C" int so_curvature_edges(const float* xyz, const int* ring,
                                  const unsigned char* mask, int n, int hw,
                                  float den_scale, float threshold,
                                  float min_range, unsigned char* out,
                                  int n_inst, const long long* istride,
                                  void* stream) {
  if (hw < 1 || hw > CE_MAX_HW || n < 0 || n_inst < 1 || n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  CeStrides is;
  for (int i = 0; i < 3; ++i) is.s[i] = istride[i];
  if (n > 0) {
    const dim3 blocks((unsigned)((n + CE_BLOCK - 1) / CE_BLOCK),
                      (unsigned)n_inst);
    curvature_edges_kernel<<<blocks, CE_BLOCK, 0, (cudaStream_t)stream>>>(
        xyz, ring, mask, n, hw, den_scale, threshold, min_range, out, is);
  }
  return (int)cudaGetLastError();
}
