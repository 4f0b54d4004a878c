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
// What bounds it on an H100: bytes and latency.  Each query reads 8 rows
// of 3C floats (8 x 192 B at C = 16) from the 12.6 MB table; arithmetic is
// ~10 operations a candidate.  The floor is the chain slot id -> row ->
// selection -> store of one warp, so the design keeps that chain short:
//   * one warp per query, 4 queries a block (all 2,048 warps of the main
//     path are resident in one wave);
//   * lanes 0-7 load the 8 slot ids as one 32-byte segment and the warp
//     broadcasts them by shuffle;
//   * lane o*4 + s owns points s*P .. s*P+P-1 of slot o (P = ceil(C/4)),
//     read as 16-byte vectors per coordinate plane where C % 16 == 0;
//   * each lane sorts its P candidates once in registers, by the packed
//     64-bit key (distance bits << 32 | lane index): distances are >= 0 or
//     inf, so unsigned order is (distance, lane) order;
//   * each of the k rounds compares only the 32 lane heads, with two
//     hardware warp reductions (redux.sync: minimum distance, then the
//     lowest lane index at that distance), and the owner pops its head;
//   * lane r keeps round r's winner, and lanes 0..k-1 write the outputs
//     together at the end (coordinates re-read from the winner's row, in
//     L1 from the distance pass).
#include "common.cuh"

#define KNN_THREADS 128

template <int P, bool VEC>
__global__ void __launch_bounds__(KNN_THREADS) knn_select_kernel(
    const float* __restrict__ pts, int C, const int* __restrict__ slots,
    const float* __restrict__ queries, int nq, int k,
    float* __restrict__ neigh, float* __restrict__ sq_out,
    unsigned char* __restrict__ valid_out, long long* __restrict__ lane_out) {
  const int qi = blockIdx.x * (KNN_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= nq) return;  // uniform per warp
  const int o = lane >> 2, c0 = (lane & 3) * P;
  const int own = lane < 8 ? slots[qi * 8 + lane] : 0;
  const int slot = __shfl_sync(0xffffffffu, own, o);
  const float qx = queries[qi * 3 + 0];
  const float qy = queries[qi * 3 + 1];
  const float qz = queries[qi * 3 + 2];
  const float* row = pts + (size_t)(slot > 0 ? slot : 0) * (3 * C);

  unsigned long long key[P];
#pragma unroll
  for (int j = 0; j < P; ++j) key[j] = ~0ull;  // no candidate: never wins
  if (slot >= 0) {
    float x[P], y[P], z[P];
    if constexpr (VEC) {
#pragma unroll
      for (int v = 0; v < P / 4; ++v) {
        const float4* at = reinterpret_cast<const float4*>(row + c0) + v;
        const float4 a = at[0];
        const float4 b = at[C / 4];
        const float4 c = at[C / 2];
        const float av[4] = {a.x, a.y, a.z, a.w};
        const float bv[4] = {b.x, b.y, b.z, b.w};
        const float cv[4] = {c.x, c.y, c.z, c.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          x[4 * v + e] = av[e];
          y[4 * v + e] = bv[e];
          z[4 * v + e] = cv[e];
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < P; ++j) {
        x[j] = y[j] = z[j] = 0.0f;
        if (c0 + j < C) {
          x[j] = row[c0 + j];
          y[j] = row[C + c0 + j];
          z[j] = row[2 * C + c0 + j];
        }
      }
    }
#pragma unroll
    for (int j = 0; j < P; ++j) {
      if (c0 + j < C) {
        const float dx = x[j] - qx, dy = y[j] - qy, dz = z[j] - qz;
        const float d = (dx * dx + dy * dy) + dz * dz;
        key[j] = ((unsigned long long)__float_as_uint(d) << 32) |
                 (unsigned)(o * C + c0 + j);
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < P; ++j)
      if (c0 + j < C)
        key[j] = ((unsigned long long)__float_as_uint(SO_BIG) << 32) |
                 (unsigned)(o * C + c0 + j);
  }

  // sort the lane's candidates once (odd-even transposition; keys unique)
#pragma unroll
  for (int r = 0; r < P; ++r) {
#pragma unroll
    for (int j = r & 1; j + 1 < P; j += 2) {
      const unsigned long long lo = key[j] < key[j + 1] ? key[j] : key[j + 1];
      const unsigned long long hi = key[j] < key[j + 1] ? key[j + 1] : key[j];
      key[j] = lo;
      key[j + 1] = hi;
    }
  }

  // k rounds over the lane heads; lane r keeps round r's winner
  unsigned win_d = 0, win_i = 0;
  for (int r = 0; r < k; ++r) {
    const unsigned hd = (unsigned)(key[0] >> 32);
    const unsigned hi = (unsigned)key[0];
    const unsigned dmin = __reduce_min_sync(0xffffffffu, hd);
    const unsigned imin =
        __reduce_min_sync(0xffffffffu, hd == dmin ? hi : 0xffffffffu);
    if (lane == r) {
      win_d = dmin;
      win_i = imin;
    }
    if (hi == imin) {  // the owner pops its head
#pragma unroll
      for (int j = 0; j + 1 < P; ++j) key[j] = key[j + 1];
      key[P - 1] = ~0ull;
    }
  }

  const int wo = (int)win_i / C;
  const int wslot = __shfl_sync(0xffffffffu, slot, (wo * 4) & 31);
  if (lane < k) {
    const int c = (int)win_i - wo * C;
    const float* wrow = pts + (size_t)(wslot > 0 ? wslot : 0) * (3 * C);
    const size_t out = (size_t)qi * k + lane;
    neigh[out * 3 + 0] = wrow[c];
    neigh[out * 3 + 1] = wrow[C + c];
    neigh[out * 3 + 2] = wrow[2 * C + c];
    const float d = __uint_as_float(win_d);
    sq_out[out] = d;
    valid_out[out] = d < SO_BIG * 0.5f;
    lane_out[out] = (long long)win_i;
  }
}

template <int P, bool VEC>
static void launch_knn(const float* pts, int C, const int* slots,
                       const float* queries, int nq, int k, float* neigh,
                       float* sq, unsigned char* valid, long long* lane,
                       cudaStream_t stream) {
  const int per_block = KNN_THREADS / 32;
  const int blocks = (nq + per_block - 1) / per_block;
  knn_select_kernel<P, VEC><<<blocks, KNN_THREADS, 0, stream>>>(
      pts, C, slots, queries, nq, k, neigh, sq, valid, lane);
}

// C in 1..32 (P = ceil(C/4) points a lane), 1 <= k <= min(32, 8*C).
extern "C" int so_knn_select(const float* pts, int C, const int* slots,
                             const float* queries, int nq, int k, float* neigh,
                             float* sq, unsigned char* valid, long long* lane,
                             void* stream) {
  if (C < 1 || C > 32 || k < 1 || k > 32 || k > 8 * C)
    return (int)cudaErrorInvalidValue;
  if (nq > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const bool vec = C % 16 == 0 && (reinterpret_cast<uintptr_t>(pts) & 15) == 0;
    switch ((C + 3) / 4) {
      case 1: launch_knn<1, false>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s); break;
      case 2: launch_knn<2, false>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s); break;
      case 3: launch_knn<3, false>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s); break;
      case 4:
        if (vec) launch_knn<4, true>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s);
        else launch_knn<4, false>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s);
        break;
      case 5: launch_knn<5, false>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s); break;
      case 6: launch_knn<6, false>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s); break;
      case 7: launch_knn<7, false>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s); break;
      default:
        if (vec) launch_knn<8, true>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s);
        else launch_knn<8, false>(pts, C, slots, queries, nq, k, neigh, sq, valid, lane, s);
        break;
    }
  }
  return (int)cudaGetLastError();
}
