// K9b select_reduced — the k nearest of each query's W reduced candidates
// (the ICP refresh rounds: rounds 2..max_icp_iters re-select from the W
// lanes that K9a reduce_candidates materialised once at the round-1 pose).
//
// Replaces: superodom_tpu/mapstate.py select_knn_reduced (:473-488).
// Plain version: mapstate.select_knn_reduced_reference.
//
// Contract, lane for lane as lax.top_k gives it: reduced lane j of query q
// is the point (x, y, z)[q, j]; its squared distance is
// ((x-qx)^2 + (y-qy)^2) + (z-qz)^2, or BIG where valid[q, j] is false.  The
// k smallest are returned in (distance, lane) order — on equal distance the
// lower lane wins — as pts f32[Q,k,3], sq f32[Q,k], valid = sq < 0.5*BIG.
// A lane that is not valid may be returned (fewer than k valid lanes); its
// point is whatever the reduced set holds there and carries valid = false.
//
// What bounds it on an H100: the launch.  A call reads Q*W*13 bytes
// (2,048 x 16: 0.43 MB, written by K9a just before and still in L2) and
// does ~10 operations a candidate; both bounds are a small fraction of a
// microsecond, below the empty-kernel floor.  What is left to shorten is
// the chain of dependent steps after the loads.
//
// Design: selection by rank.  A group of G lanes serves one query (G = 16,
// two queries a warp, when W <= 16; else G = 32); lane j holds candidate j
// and its key (distance bits, j).  Its rank is the number of the query's
// keys below its own, counted from the W distance bits that W independent
// shuffles fetch (the lane half of a key is the shuffle's source lane).
// The comparison is unsigned on the bits, which orders NaN after BIG as
// the earlier design's k rounds of warp minima did.  The keys are distinct,
// so the ranks are a permutation of 0..W-1, and the lane of rank r < k
// writes its own point, distance and validity to output slot r: slot r
// holds the r-th smallest key, what round r of the minima picked.
#include "common.cuh"

#define SR_THREADS 128

template <int G>
__global__ void __launch_bounds__(SR_THREADS) select_reduced_kernel(
    const float* __restrict__ rx, const float* __restrict__ ry,
    const float* __restrict__ rz, const unsigned char* __restrict__ rvalid,
    int W, const float* __restrict__ queries, int nq, int k,
    float* __restrict__ neigh, float* __restrict__ sq_out,
    unsigned char* __restrict__ valid_out) {
  const int lane32 = threadIdx.x & 31;
  const int lane = lane32 & (G - 1);
  const int qi = (blockIdx.x * (SR_THREADS / 32) + (threadIdx.x >> 5)) *
                     (32 / G) +
                 lane32 / G;
  if (qi >= nq) return;  // uniform per group
  const unsigned gmask = G == 32 ? 0xffffffffu : 0xffffu << (lane32 & 16);
  const float qx = queries[qi * 3 + 0], qy = queries[qi * 3 + 1],
              qz = queries[qi * 3 + 2];
  float x = 0.0f, y = 0.0f, z = 0.0f;
  unsigned d = 0xffffffffu;  // no candidate: compared by no lane
  if (lane < W) {
    const size_t at = (size_t)qi * W + lane;
    x = rx[at];
    y = ry[at];
    z = rz[at];
    float dist = SO_BIG;
    if (rvalid[at]) {
      const float dx = x - qx, dy = y - qy, dz = z - qz;
      dist = (dx * dx + dy * dy) + dz * dz;
    }
    d = __float_as_uint(dist);
  }

  // the rank of key (d, lane) among the query's W keys
  int rank = 0;
#pragma unroll 4
  for (int i = 0; i < W; ++i) {
    const unsigned di = __shfl_sync(gmask, d, i, G);
    rank += (di < d || (di == d && i < lane)) ? 1 : 0;
  }

  if (lane < W && rank < k) {
    const size_t out = (size_t)qi * k + rank;
    neigh[out * 3 + 0] = x;
    neigh[out * 3 + 1] = y;
    neigh[out * 3 + 2] = z;
    const float dist = __uint_as_float(d);
    sq_out[out] = dist;
    valid_out[out] = dist < SO_BIG * 0.5f;
  }
}

template <int G>
static void so_launch_select_reduced(const float* rx, const float* ry,
                                     const float* rz,
                                     const unsigned char* rvalid, int W,
                                     const float* queries, int nq, int k,
                                     float* neigh, float* sq,
                                     unsigned char* valid,
                                     cudaStream_t stream) {
  const int per_block = (SR_THREADS / 32) * (32 / G);
  select_reduced_kernel<G><<<(nq + per_block - 1) / per_block, SR_THREADS, 0,
                             stream>>>(rx, ry, rz, rvalid, W, queries, nq, k,
                                       neigh, sq, valid);
}

// 1 <= k <= W <= 32.
extern "C" int so_select_reduced(const float* rx, const float* ry,
                                 const float* rz, const unsigned char* rvalid,
                                 int W, const float* queries, int nq, int k,
                                 float* neigh, float* sq, unsigned char* valid,
                                 void* stream) {
  if (W < 1 || W > 32 || k < 1 || k > W) return (int)cudaErrorInvalidValue;
  if (nq > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (W <= 16)
      so_launch_select_reduced<16>(rx, ry, rz, rvalid, W, queries, nq, k,
                                   neigh, sq, valid, s);
    else
      so_launch_select_reduced<32>(rx, ry, rz, rvalid, W, queries, nq, k,
                                   neigh, sq, valid, s);
  }
  return (int)cudaGetLastError();
}
