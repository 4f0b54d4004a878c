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
//
// K9a reduce_candidates is this function at k = W (the refresh width, 16 on
// the reference-envelope path) with another output: the W winners'
// coordinates as planes x, y, z f32[Q,W] with valid bool[Q,W], no distances
// and no lane ids — the layout K9b select_reduced (select_reduced.cu) reads
// row by row.  It replaces superodom_tpu/mapstate.py reduce_candidates
// (:444-470, plain version mapstate.reduce_candidates_reference), shares the
// device code below through the PLANAR template parameter, and has its own
// entry point so that its launches are counted apart from K2's.  A lane
// that is not valid (fewer than W live candidates) holds whatever its
// winner's row holds there — the BIG sentinel of an empty lane, or a point
// of row 0 for a missing slot — exactly as the plain version gathers it.
#include "common.cuh"

#define KNN_THREADS 128

// PLANAR false (K2): o0 = neighbours [Q,k,3], o1 = sq [Q,k], lane_out set.
// PLANAR true (K9a): o0, o1, o2 = x, y, z [Q,k]; lane_out unused.
template <int P, bool VEC, bool PLANAR>
__global__ void __launch_bounds__(KNN_THREADS) knn_select_kernel(
    const float* __restrict__ pts, int C, const int* __restrict__ slots,
    const float* __restrict__ queries, int nq, int k,
    float* __restrict__ o0, float* __restrict__ o1, float* __restrict__ o2,
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
    const float d = __uint_as_float(win_d);
    if constexpr (PLANAR) {
      o0[out] = wrow[c];
      o1[out] = wrow[C + c];
      o2[out] = wrow[2 * C + c];
    } else {
      o0[out * 3 + 0] = wrow[c];
      o0[out * 3 + 1] = wrow[C + c];
      o0[out * 3 + 2] = wrow[2 * C + c];
      o1[out] = d;
      lane_out[out] = (long long)win_i;
    }
    valid_out[out] = d < SO_BIG * 0.5f;
  }
}

template <int P, bool VEC, bool PLANAR>
static void launch_knn(const float* pts, int C, const int* slots,
                       const float* queries, int nq, int k, float* o0,
                       float* o1, float* o2, unsigned char* valid,
                       long long* lane, cudaStream_t stream) {
  const int per_block = KNN_THREADS / 32;
  const int blocks = (nq + per_block - 1) / per_block;
  knn_select_kernel<P, VEC, PLANAR><<<blocks, KNN_THREADS, 0, stream>>>(
      pts, C, slots, queries, nq, k, o0, o1, o2, valid, lane);
}

// C in 1..32 (P = ceil(C/4) points a lane), 1 <= k <= min(32, 8*C).
template <bool PLANAR>
static int knn_dispatch(const float* pts, int C, const int* slots,
                        const float* queries, int nq, int k, float* o0,
                        float* o1, float* o2, unsigned char* valid,
                        long long* lane, void* stream) {
  if (C < 1 || C > 32 || k < 1 || k > 32 || k > 8 * C)
    return (int)cudaErrorInvalidValue;
  if (nq > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const bool vec = C % 16 == 0 && (reinterpret_cast<uintptr_t>(pts) & 15) == 0;
#define KNN_GO(P, V) \
  launch_knn<P, V, PLANAR>(pts, C, slots, queries, nq, k, o0, o1, o2, valid, lane, s)
    switch ((C + 3) / 4) {
      case 1: KNN_GO(1, false); break;
      case 2: KNN_GO(2, false); break;
      case 3: KNN_GO(3, false); break;
      case 4:
        if (vec) KNN_GO(4, true);
        else KNN_GO(4, false);
        break;
      case 5: KNN_GO(5, false); break;
      case 6: KNN_GO(6, false); break;
      case 7: KNN_GO(7, false); break;
      default:
        if (vec) KNN_GO(8, true);
        else KNN_GO(8, false);
        break;
    }
#undef KNN_GO
  }
  return (int)cudaGetLastError();
}

extern "C" int so_knn_select(const float* pts, int C, const int* slots,
                             const float* queries, int nq, int k, float* neigh,
                             float* sq, unsigned char* valid, long long* lane,
                             void* stream) {
  return knn_dispatch<false>(pts, C, slots, queries, nq, k, neigh, sq, nullptr,
                             valid, lane, stream);
}

// K9a: the W nearest candidates as planes x, y, z f32[Q,W], valid bool[Q,W].
extern "C" int so_reduce_candidates(const float* pts, int C, const int* slots,
                                    const float* queries, int nq, int w,
                                    float* x, float* y, float* z,
                                    unsigned char* valid, void* stream) {
  return knn_dispatch<true>(pts, C, slots, queries, nq, w, x, y, z, valid,
                            nullptr, stream);
}
