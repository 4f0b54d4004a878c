// K2 knn_select — the k nearest stored points of each query among the
// 8*C candidate lanes of its 8 octant slots.
//
// Replaces: superodom_tpu/mapstate.py select_knn (:406-429), together with
// the candidate row gather of gather_candidates (:385-392) — the function
// the removed Pallas kernel ops/pallas_knn.py (select_knn_pallas /
// _knn_kernel) computed.  Plain version: mapstate.knn_select_reference.
//
// Contract, lane for lane as lax.top_k gives it: candidate lane o*C + c is
// point c of octant slot o, read from row max(slot, 0) of the
// coordinate-planar [slots, 3C] point table.  Its squared distance is
// ((x-qx)^2 + (y-qy)^2) + (z-qz)^2, or BIG when the slot is missing; an
// empty lane of a live slot holds the BIG sentinel and squares to inf.
// The k smallest are returned in (distance, lane) order — on equal
// distance the lower lane wins — with valid = sq < 0.5*BIG.
//
// What bounds it on an H100: bytes.  Each query reads 8 rows of 3C floats
// (8 x 192 B at C = 16) from the 12.6 MB table; arithmetic is ~10 flops a
// candidate.  Design: one warp per query; the warp's lanes read the rows
// coalesced (lane i takes candidates i, i+32, ...) straight from the table
// into registers, so no [Q, 8, 3C] candidate array is written to device
// memory (the JAX path materialises it); the k winners come from k rounds
// of a warp-wide lexicographic (distance, lane) arg-min over shuffles.
#include <math.h>

#include "common.cuh"

#define KNN_MAX_PER_LANE 8  // supports 8*C <= 256 candidates (C <= 32)

__global__ void knn_select_kernel(const float* __restrict__ pts, int C,
                                  const int* __restrict__ slots,
                                  const float* __restrict__ queries, int nq,
                                  int k, float* __restrict__ neigh,
                                  float* __restrict__ sq_out,
                                  unsigned char* __restrict__ valid_out,
                                  long long* __restrict__ lane_out) {
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= nq) return;  // uniform per warp
  const float qx = queries[warp * 3 + 0];
  const float qy = queries[warp * 3 + 1];
  const float qz = queries[warp * 3 + 2];
  const int nc = 8 * C;

  float d[KNN_MAX_PER_LANE], x[KNN_MAX_PER_LANE], y[KNN_MAX_PER_LANE],
      z[KNN_MAX_PER_LANE];
#pragma unroll
  for (int j = 0; j < KNN_MAX_PER_LANE; ++j) {
    const int i = lane + 32 * j;
    d[j] = INFINITY;
    x[j] = y[j] = z[j] = 0.0f;
    if (i < nc) {
      const int o = i / C, c = i - o * C;
      const int s = slots[warp * 8 + o];
      const float* row = pts + (size_t)(s > 0 ? s : 0) * (3 * C);
      x[j] = row[c];
      y[j] = row[C + c];
      z[j] = row[2 * C + c];
      const float dx = x[j] - qx, dy = y[j] - qy, dz = z[j] - qz;
      d[j] = s >= 0 ? (dx * dx + dy * dy) + dz * dz : SO_BIG;
    }
  }

  unsigned taken = 0;  // bit j: this lane's candidate j already selected
  for (int r = 0; r < k; ++r) {
    // this lane's best untaken candidate; lanes past nc never win
    float bd = INFINITY;
    int bi = 0x7fffffff;
#pragma unroll
    for (int j = 0; j < KNN_MAX_PER_LANE; ++j) {
      const int i = lane + 32 * j;
      if (i < nc && !((taken >> j) & 1u) &&
          (d[j] < bd || (d[j] == bd && i < bi))) {
        bd = d[j];
        bi = i;
      }
    }
    // warp-wide lexicographic arg-min; every lane ends with the winner
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(0xffffffffu, bd, off);
      const int oi = __shfl_xor_sync(0xffffffffu, bi, off);
      if (od < bd || (od == bd && oi < bi)) {
        bd = od;
        bi = oi;
      }
    }
    if (bi != 0x7fffffff && (bi & 31) == lane) {
      const int j = bi >> 5;
      taken |= 1u << j;
      const size_t o = (size_t)warp * k + r;
      neigh[o * 3 + 0] = x[j];
      neigh[o * 3 + 1] = y[j];
      neigh[o * 3 + 2] = z[j];
      sq_out[o] = bd;
      valid_out[o] = bd < SO_BIG * 0.5f;
      lane_out[o] = bi;
    }
  }
}

extern "C" int so_knn_select(const float* pts, int C, const int* slots,
                             const float* queries, int nq, int k, float* neigh,
                             float* sq, unsigned char* valid, long long* lane,
                             void* stream) {
  if (nq > 0) {
    const int threads = 256;
    const int blocks = (int)(((long long)nq * 32 + threads - 1) / threads);
    knn_select_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        pts, C, slots, queries, nq, k, neigh, sq, valid, lane);
  }
  return (int)cudaGetLastError();
}
