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
// the reference-envelope path, 20 on the edge map) with other outputs: the
// W winners' coordinates as planes x, y, z f32[Q,W] with valid bool[Q,W] —
// the layout K9b select_reduced (select_reduced.cu) reads row by row — and
// the k nearest of those W lanes as K9b would select them at the same
// queries: neigh f32[Q,k,3], sq f32[Q,k] (BIG where not valid), valid
// bool[Q,k].  Those are K9a's first k winners: K9b recomputes a valid
// lane's distance from the same floats by the same expression, gives every
// lane that is not valid BIG (after every valid one; K9a ranks those lanes
// after the valid ones too), and breaks ties by the reduced lane, which is
// K9a's rank.  So the refresh round that makes the reduced set needs no K9b
// launch.  It replaces superodom_tpu/mapstate.py reduce_candidates
// (:444-470) and, in that round, select_knn_reduced (:473-488); plain
// version mapstate.reduce_candidates_reference.  A lane that is not valid
// (fewer than W live candidates) holds whatever its winner's row holds
// there — the BIG sentinel of an empty lane, or a point of row 0 for a
// missing slot — exactly as the plain version gathers it.
//
// K9a's selection (reduce_kernel) shares K2's candidate keys and sort but
// not its W dependent rounds of warp minima.  Threshold, then rank:
//   * tau = the head of rank W-1 among the 32 lane heads, ranked by 32
//     independent shuffles of the head distances (a lower lane holds lower
//     candidate lanes, so a tie goes to the lower lane: one match_any);
//   * every winner is <= tau, since W heads are, and a lane whose head has
//     rank h can win only at its places j < W - h (its key at j has h + j
//     keys below it): each lane's keys that pass both (a prefix of its
//     sorted list, c <= P of them) are compacted into the warp's list in
//     shared memory at the count of the lower lanes' (ballots of the bits
//     of c);
//   * each listed key's rank is the count of listed keys below it (the
//     keys are distinct, and every key below a winner is listed), m
//     broadcast reads of the list, a lane ranking its two listed keys in
//     one read up to m = 64; the lane holding the key of rank r < W writes
//     winner r.
// The dependent chain is a handful of steps instead of W rounds, but it
// executes more shuffles and shared-memory reads than W rounds execute warp
// reductions: on the H100 it takes longer than the rounds at the paths'
// shapes, most of all when a fleet fills the card (PERF.md).
//
// Instances: one launch serves n_inst independent maps (the batched step
// of superodom_tpu_torch/parallel.py).  Instance i is blockIdx.y: its
// point table, slot ids and queries start istride[0..2] elements after
// instance 0's (0: shared), its slot ids index its own table, and its
// outputs follow at i * Q * k (times 3 for the neighbours).  Each instance
// computes exactly what a launch on its own inputs computes, and
// n_inst = 1 is the single launch.
//
// Gathered mode (so_knn_select_gathered): the same selection over
// candidates the caller has already gathered — the JAX package's public
// select_knn(cand, cvalid, queries, k) (superodom_tpu/mapstate.py:406-429,
// the removed Pallas kernel's contract).  cand f32[Q,8,3C] holds each
// query's 8 octant rows contiguously, so it is read as a table of Q*8 rows
// whose row for (query q, octant o) is q*8 + o; cvalid bool[Q,8C] is a
// lane mask that need not be constant over an octant's C lanes, so every
// lane reads its own flag, and a lane whose flag is false has distance BIG
// (where a slot-mode lane is BIG only when its whole slot is missing).
// Everything else — the sort, the k rounds, the (distance, lane) order
// with the lower lane winning a tie, the outputs — is K2's code.  Plain
// version: mapstate.select_knn_reference.  Only the library's
// correspondence functions call it; no replay path launches it.  What
// bounds it: bytes, as K2, but more of them — each query reads its own 8
// gathered rows (8 x 192 B at C = 16) and 8C mask bytes, shared with no
// other query, where K2 reads rows that neighbouring queries share in L2.
#include "common.cuh"

#define KNN_THREADS 128

// Each lane's P candidate keys, sorted: lane o*4 + s owns points
// s*P .. s*P+P-1 of octant slot o; returns that slot's id (lanes 0-7 load
// the 8 ids, the warp broadcasts them by shuffle).  GATHERED: pts = cand
// [Q*8, 3C], slots unused, the lane mask cvalid [Q, 8C].
template <int P, bool VEC, bool GATHERED>
static __device__ __forceinline__ int knn_lane_keys(
    const float* __restrict__ pts, int C, const int* __restrict__ slots,
    const unsigned char* __restrict__ cvalid, int qi, int lane, float qx,
    float qy, float qz, unsigned long long key[P]) {
  const int o = lane >> 2, c0 = (lane & 3) * P;
  int slot;
  if constexpr (GATHERED) {
    slot = qi * 8 + o;  // the query's own gathered row of octant o
  } else {
    const int own = lane < 8 ? slots[qi * 8 + lane] : 0;
    slot = __shfl_sync(0xffffffffu, own, o);
  }
  const float* row = pts + (size_t)(slot > 0 ? slot : 0) * (3 * C);

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
        float d = (dx * dx + dy * dy) + dz * dz;
        if constexpr (GATHERED)
          if (!cvalid[(size_t)qi * 8 * C + o * C + c0 + j]) d = SO_BIG;
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
  return slot;
}

// K2: o0 = neighbours [Q,k,3], o1 = sq [Q,k], lane_out.  GATHERED: pts =
// cand [Q*8, 3C], slots unused, the lane mask cvalid [Q, 8C].
template <int P, bool VEC, bool GATHERED>
__global__ void __launch_bounds__(KNN_THREADS) knn_select_kernel(
    const float* __restrict__ pts, int C, const int* __restrict__ slots,
    const unsigned char* __restrict__ cvalid,
    const float* __restrict__ queries, int nq, int k,
    float* __restrict__ o0, float* __restrict__ o1,
    unsigned char* __restrict__ valid_out, long long* __restrict__ lane_out,
    long long pts_is, long long slots_is, long long queries_is) {
  {
    const size_t outs = (size_t)blockIdx.y * nq * k;
    pts += blockIdx.y * pts_is;
    slots += blockIdx.y * slots_is;
    queries += blockIdx.y * queries_is;
    o0 += 3 * outs;
    o1 += outs;
    lane_out += outs;
    valid_out += outs;
  }
  const int qi = blockIdx.x * (KNN_THREADS / 32) + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (qi >= nq) return;  // uniform per warp
  const float qx = queries[qi * 3 + 0];
  const float qy = queries[qi * 3 + 1];
  const float qz = queries[qi * 3 + 2];
  unsigned long long key[P];
  const int slot = knn_lane_keys<P, VEC, GATHERED>(pts, C, slots, cvalid, qi,
                                                   lane, qx, qy, qz, key);

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
    o0[out * 3 + 0] = wrow[c];
    o0[out * 3 + 1] = wrow[C + c];
    o0[out * 3 + 2] = wrow[2 * C + c];
    o1[out] = d;
    lane_out[out] = (long long)win_i;
    valid_out[out] = d < SO_BIG * 0.5f;
  }
}

// K9a's winner r of query qi, the candidate of key x: its point as read
// from its octant's row, its validity, and (r < k) K9b's outputs
static __device__ __forceinline__ void reduce_write(
    const float* __restrict__ pts, int C, const int* slot_of,
    unsigned long long x, int r, int qi, int W, int k, float* __restrict__ ox,
    float* __restrict__ oy, float* __restrict__ oz,
    unsigned char* __restrict__ ovalid, float* __restrict__ neigh,
    float* __restrict__ sq, unsigned char* __restrict__ nvalid) {
  const unsigned idx = (unsigned)x;
  const int o = (int)idx / C, cc = (int)idx - o * C;
  const int ws = slot_of[o];
  const float* wrow = pts + (size_t)(ws > 0 ? ws : 0) * (3 * C);
  const float px = wrow[cc], py = wrow[C + cc], pz = wrow[2 * C + cc];
  const float d = __uint_as_float((unsigned)(x >> 32));
  const bool ok = d < SO_BIG * 0.5f;
  const size_t at = (size_t)qi * W + r;
  ox[at] = px;
  oy[at] = py;
  oz[at] = pz;
  ovalid[at] = ok;
  if (r < k) {
    const size_t kt = (size_t)qi * k + r;
    neigh[kt * 3 + 0] = px;
    neigh[kt * 3 + 1] = py;
    neigh[kt * 3 + 2] = pz;
    sq[kt] = ok ? d : SO_BIG;
    nvalid[kt] = ok;
  }
}

// K9a: the W nearest as planes x, y, z [Q,W] with valid [Q,W], and the k
// nearest of those as K9b gives them: neigh [Q,k,3], sq [Q,k] (BIG where
// not valid), nvalid [Q,k].
template <int P, bool VEC>
__global__ void __launch_bounds__(KNN_THREADS) reduce_kernel(
    const float* __restrict__ pts, int C, const int* __restrict__ slots,
    const float* __restrict__ queries, int nq, int W, int k,
    float* __restrict__ ox, float* __restrict__ oy, float* __restrict__ oz,
    unsigned char* __restrict__ ovalid, float* __restrict__ neigh,
    float* __restrict__ sq, unsigned char* __restrict__ nvalid,
    long long pts_is, long long slots_is, long long queries_is) {
  __shared__ unsigned long long s_list[KNN_THREADS / 32][32 * P];
  __shared__ int s_slot[KNN_THREADS / 32][8];
  {
    const size_t outs = (size_t)blockIdx.y * nq;
    pts += blockIdx.y * pts_is;
    slots += blockIdx.y * slots_is;
    queries += blockIdx.y * queries_is;
    ox += outs * W;
    oy += outs * W;
    oz += outs * W;
    ovalid += outs * W;
    neigh += outs * k * 3;
    sq += outs * k;
    nvalid += outs * k;
  }
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * (KNN_THREADS / 32) + warp;
  const int lane = threadIdx.x & 31;
  if (qi >= nq) return;  // uniform per warp
  const float qx = queries[qi * 3 + 0];
  const float qy = queries[qi * 3 + 1];
  const float qz = queries[qi * 3 + 2];
  unsigned long long key[P];
  const int slot = knn_lane_keys<P, VEC, false>(pts, C, slots, nullptr, qi,
                                                lane, qx, qy, qz, key);
  if ((lane & 3) == 0) s_slot[warp][lane >> 2] = slot;

  // 1. tau = the head of rank W-1 among the 32 lane heads.  A lower lane
  // holds lower candidate lanes, so the key order of two heads is their
  // (distance, lane) order: the rank counts the lower distances (32
  // independent shuffles) and the lower lanes at an equal one.
  const unsigned below = (1u << lane) - 1u;
  const unsigned hd = (unsigned)(key[0] >> 32);
  int hr = __popc(__match_any_sync(0xffffffffu, hd) & below);
#pragma unroll
  for (int i = 0; i < 32; ++i)
    hr += __shfl_sync(0xffffffffu, hd, i) < hd ? 1 : 0;
  const int tl = __ffs(__ballot_sync(0xffffffffu, hr == W - 1)) - 1;
  const unsigned long long tau = __shfl_sync(0xffffffffu, key[0], tl);

  // 2. every winner is <= tau (W heads are), and a lane's key at j has at
  // least hr + j keys below it (the hr lower heads and its own j), so only
  // its keys <= tau at j < W - hr can win: a prefix of its sorted list (c
  // <= P of them), which goes to the warp's list at the count of the lower
  // lanes' (ballots of the bits of c).  Every key below a winner is a
  // winner, so it is listed too.
  int c = 0;
#pragma unroll
  for (int j = 0; j < P; ++j) c += key[j] <= tau && j < W - hr ? 1 : 0;
  int e = 0, m = 0;
#pragma unroll
  for (int b = 0; (1 << b) <= P; ++b) {
    const unsigned bal = __ballot_sync(0xffffffffu, (c >> b) & 1);
    e += __popc(bal & below) << b;
    m += __popc(bal) << b;
  }
  unsigned long long* list = s_list[warp];
#pragma unroll
  for (int j = 0; j < P; ++j)
    if (j < c) list[e + j] = key[j];
  __syncwarp();

  // 3. the rank of a listed winner is the count of listed keys below it
  // (the keys are distinct; a lane's sentinel ~0 is listed only when every
  // candidate is, and ranks after them); a listed key that does not win
  // has all W winners below it.  Up to 64 listed keys, one read of the
  // list serves a lane's two.
  if (m <= 64) {
    const unsigned long long x0 = lane < m ? list[lane] : ~0ull;
    const unsigned long long x1 = lane + 32 < m ? list[lane + 32] : ~0ull;
    int r0 = 0, r1 = 0;
    if (m <= 32) {
#pragma unroll 4
      for (int i = 0; i < m; ++i) r0 += list[i] < x0 ? 1 : 0;
    } else {
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const unsigned long long y = list[i];
        r0 += y < x0 ? 1 : 0;
        r1 += y < x1 ? 1 : 0;
      }
    }
    if (lane < m && r0 < W)
      reduce_write(pts, C, s_slot[warp], x0, r0, qi, W, k, ox, oy, oz,
                   ovalid, neigh, sq, nvalid);
    if (lane + 32 < m && r1 < W)
      reduce_write(pts, C, s_slot[warp], x1, r1, qi, W, k, ox, oy, oz,
                   ovalid, neigh, sq, nvalid);
  } else {
    for (int p = lane; p - lane < m; p += 32) {
      const unsigned long long x = p < m ? list[p] : ~0ull;
      int r = 0;
      for (int i = 0; i < m; ++i) r += list[i] < x ? 1 : 0;
      if (p < m && r < W)
        reduce_write(pts, C, s_slot[warp], x, r, qi, W, k, ox, oy, oz,
                     ovalid, neigh, sq, nvalid);
    }
  }
}

// one launch per P = ceil(C/4) points a lane, with 16-byte vectors
// (VEC) where C % 16 == 0 and every instance's table lies on a 16-byte line
#define KNN_SWITCH(C, vec, GO)                   \
  switch (((C) + 3) / 4) {                       \
    case 1: GO(1, false); break;                 \
    case 2: GO(2, false); break;                 \
    case 3: GO(3, false); break;                 \
    case 4:                                      \
      if (vec) GO(4, true);                      \
      else GO(4, false);                         \
      break;                                     \
    case 5: GO(5, false); break;                 \
    case 6: GO(6, false); break;                 \
    case 7: GO(7, false); break;                 \
    default:                                     \
      if (vec) GO(8, true);                      \
      else GO(8, false);                         \
      break;                                     \
  }

static bool knn_vec(int C, const float* pts, const long long* istride) {
  return C % 16 == 0 && (reinterpret_cast<uintptr_t>(pts) & 15) == 0 &&
         (istride[0] & 3) == 0;
}

static dim3 knn_grid(int nq, int n_inst) {
  const int per_block = KNN_THREADS / 32;
  return dim3((unsigned)((nq + per_block - 1) / per_block), (unsigned)n_inst);
}

// C in 1..32 (P = ceil(C/4) points a lane), 1 <= k <= min(32, 8*C);
// istride (host) = {pts, slots, queries} instance strides in elements.
template <bool GATHERED = false>
static int knn_dispatch(const float* pts, int C, const int* slots,
                        const unsigned char* cvalid,
                        const float* queries, int nq, int k, float* neigh,
                        float* sq, unsigned char* valid, long long* lane,
                        int n_inst, const long long* istride, void* stream) {
  if (C < 1 || C > 32 || k < 1 || k > 32 || k > 8 * C || n_inst < 1 ||
      n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  if (nq > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
#define KNN_GO(P, V)                                                      \
  knn_select_kernel<P, V, GATHERED><<<knn_grid(nq, n_inst), KNN_THREADS,  \
                                      0, s>>>(                            \
      pts, C, slots, cvalid, queries, nq, k, neigh, sq, valid, lane,      \
      istride[0], istride[1], istride[2])
    KNN_SWITCH(C, knn_vec(C, pts, istride), KNN_GO)
#undef KNN_GO
  }
  return (int)cudaGetLastError();
}

extern "C" int so_knn_select(const float* pts, int C, const int* slots,
                             const float* queries, int nq, int k, float* neigh,
                             float* sq, unsigned char* valid, long long* lane,
                             int n_inst, const long long* istride,
                             void* stream) {
  return knn_dispatch(pts, C, slots, nullptr, queries, nq, k, neigh, sq,
                      valid, lane, n_inst, istride, stream);
}

// Gathered mode: cand f32[Q,8,3C], cvalid bool[Q,8C], queries f32[Q,3] ->
// K2's outputs for one instance.
extern "C" int so_knn_select_gathered(const float* cand, int C,
                                      const unsigned char* cvalid,
                                      const float* queries, int nq, int k,
                                      float* neigh, float* sq,
                                      unsigned char* valid, long long* lane,
                                      void* stream) {
  if ((long long)nq * 8 > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  const long long none[3] = {0, 0, 0};
  return knn_dispatch<true>(cand, C, nullptr, cvalid, queries, nq, k, neigh,
                            sq, valid, lane, 1, none, stream);
}

// K9a: the W nearest candidates as planes x, y, z f32[Q,W], valid
// bool[Q,W], and the k nearest of them as K9b selects them from those
// planes: neigh f32[Q,k,3], sq f32[Q,k], nvalid bool[Q,k].  C in 1..32,
// 1 <= k <= w <= min(32, 8*C).
extern "C" int so_reduce_candidates(const float* pts, int C, const int* slots,
                                    const float* queries, int nq, int w,
                                    int k, float* x, float* y, float* z,
                                    unsigned char* valid, float* neigh,
                                    float* sq, unsigned char* nvalid,
                                    int n_inst, const long long* istride,
                                    void* stream) {
  if (C < 1 || C > 32 || w > 32 || w > 8 * C || k < 1 || k > w ||
      n_inst < 1 || n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  if (nq > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
#define RED_GO(P, V)                                                      \
  reduce_kernel<P, V><<<knn_grid(nq, n_inst), KNN_THREADS, 0, s>>>(      \
      pts, C, slots, queries, nq, w, k, x, y, z, valid, neigh, sq, nvalid, \
      istride[0], istride[1], istride[2])
    KNN_SWITCH(C, knn_vec(C, pts, istride), RED_GO)
#undef RED_GO
  }
  return (int)cudaGetLastError();
}
