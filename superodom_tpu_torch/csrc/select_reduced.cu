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
// microsecond, below the empty-kernel floor.  So the design is the simplest
// that keeps the chain short: one warp a query (W <= 32), lane j holds
// candidate j (the row of W floats is one coalesced load a plane), k rounds
// of two hardware warp minima (redux.sync) over packed (distance, lane)
// keys as in K2, the winners' coordinates fetched by shuffle, lanes 0..k-1
// write together.
#include "common.cuh"

#define SR_THREADS 128

__global__ void __launch_bounds__(SR_THREADS) select_reduced_kernel(
    const float* __restrict__ rx, const float* __restrict__ ry,
    const float* __restrict__ rz, const unsigned char* __restrict__ rvalid,
    int W, const float* __restrict__ queries, int nq, int k,
    float* __restrict__ neigh, float* __restrict__ sq_out,
    unsigned char* __restrict__ valid_out) {
  const int qi = blockIdx.x * (SR_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= nq) return;  // uniform per warp
  float x = 0.0f, y = 0.0f, z = 0.0f;
  unsigned long long key = ~0ull;  // no candidate: never wins
  if (lane < W) {
    const size_t at = (size_t)qi * W + lane;
    x = rx[at];
    y = ry[at];
    z = rz[at];
    float d = SO_BIG;
    if (rvalid[at]) {
      const float dx = x - queries[qi * 3 + 0];
      const float dy = y - queries[qi * 3 + 1];
      const float dz = z - queries[qi * 3 + 2];
      d = (dx * dx + dy * dy) + dz * dz;
    }
    key = ((unsigned long long)__float_as_uint(d) << 32) | (unsigned)lane;
  }

  // k rounds over the lanes; lane r keeps round r's winner
  unsigned win_d = 0, win_i = 0;
  for (int r = 0; r < k; ++r) {
    const unsigned hd = (unsigned)(key >> 32);
    const unsigned hi = (unsigned)key;
    const unsigned dmin = __reduce_min_sync(0xffffffffu, hd);
    const unsigned imin =
        __reduce_min_sync(0xffffffffu, hd == dmin ? hi : 0xffffffffu);
    if (lane == r) {
      win_d = dmin;
      win_i = imin;
    }
    if (hi == imin) key = ~0ull;  // the winner leaves
  }

  const float px = __shfl_sync(0xffffffffu, x, (int)(win_i & 31u));
  const float py = __shfl_sync(0xffffffffu, y, (int)(win_i & 31u));
  const float pz = __shfl_sync(0xffffffffu, z, (int)(win_i & 31u));
  if (lane < k) {
    const size_t out = (size_t)qi * k + lane;
    neigh[out * 3 + 0] = px;
    neigh[out * 3 + 1] = py;
    neigh[out * 3 + 2] = pz;
    const float d = __uint_as_float(win_d);
    sq_out[out] = d;
    valid_out[out] = d < SO_BIG * 0.5f;
  }
}

// 1 <= k <= W <= 32.
extern "C" int so_select_reduced(const float* rx, const float* ry,
                                 const float* rz, const unsigned char* rvalid,
                                 int W, const float* queries, int nq, int k,
                                 float* neigh, float* sq, unsigned char* valid,
                                 void* stream) {
  if (W < 1 || W > 32 || k < 1 || k > W) return (int)cudaErrorInvalidValue;
  if (nq > 0) {
    const int per_block = SR_THREADS / 32;
    select_reduced_kernel<<<(nq + per_block - 1) / per_block, SR_THREADS, 0,
                            (cudaStream_t)stream>>>(
        rx, ry, rz, rvalid, W, queries, nq, k, neigh, sq, valid);
  }
  return (int)cudaGetLastError();
}
