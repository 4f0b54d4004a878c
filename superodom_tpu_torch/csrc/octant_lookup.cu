// K1 octant_lookup — the 2x2x2 cells nearest each query, looked up in the
// voxel-hash map's bucket rows.
//
// Replaces: superodom_tpu/mapstate.py gather_candidates (its lookup half,
// :365-382) + lookup_packed (:152-161) + _bucket_of / _bucket_scramble
// (:116-126).  Plain version: mapstate.octant_lookup_reference.
//
// Per query q (world frame, Q <= 2,048 features at the predicted pose) and
// octant o = 4*bx + 2*by + bz: cell = floor(q / cell_size); along each axis
// the neighbour cell is on the side of the half cell the query lies in;
// the cell packs into 10-bit-per-axis key words; the bucket is the fmix
// scramble of the key masked to NB buckets; the slot is the FIRST lane of
// that bucket's B-key row holding the key (-1 if none).
//
// What bounds it on an H100: neither the bytes that reach device memory
// (queries, the touched rows, the slot ids: ~0.1 us) nor arithmetic.  Each
// (query, octant) probe compares one whole B = 128-key row (512 bytes):
// 16,384 probes read 8.4 MB through L1 / L2 (the 256 KB key table stays in
// the 50 MB L2), and the launch is so short that what costs is the chain
// query -> key -> row -> match -> store of one warp.  Design:
//   * 8 lanes share a probe, so a warp serves 4 octants and two
//     warps a query: the main path's 2,048 queries are 4,096 warps,
//     resident on the card in one wave.  4, 16 and 32 lanes a probe
//     measured slower (PERF.md);
//   * every lane starts all its 16-byte loads of the row before the first
//     compare (4 independent int4 loads a lane at B = 128; the lanes of a
//     probe read neighbouring vectors, 128 contiguous bytes a load
//     instruction), so a probe pays one memory round trip whether it hits
//     or misses.  Reading the row's first 32 keys alone and the rest only
//     after a miss saved nothing on the main path's data, where all hits
//     but one lie there (PERF.md), and costs a miss a second round trip;
//   * a lane keeps the lowest key index it matched, and the probe's lanes
//     take the minimum with one hardware warp reduction (redux.sync over
//     the probe's lanes): the lowest index in the row wins, as in the plain
//     version, also where a row holds a key twice;
//   * the quotient is the IEEE one (__fdiv_rn), as the plain version
//     divides: that is what makes the cell floor agree with it to the bit.
//
// Instances: one launch serves n_inst independent maps (the batched step
// of superodom_tpu_torch/parallel.py).  Instance i is blockIdx.y: its key
// table starts istride[0] ints after instance 0's (0: one table shared),
// its queries istride[1] floats after, its slot ids at i * Q * 8.  Each
// instance computes exactly what a launch on its own inputs computes, and
// n_inst = 1 is the single launch.
//
// Shard window: the table may be one shard of a table of nb_total buckets
// (superodom_tpu_torch/mapstate.py ShardedMap), holding its nb consecutive
// buckets [bucket_lo, bucket_lo + nb).  The bucket is then the scramble
// masked to nb_total; a probe whose bucket lies outside the window reads
// nothing and answers -1, and a hit answers the GLOBAL slot b * B + lane, so
// the shards' answers merge by an elementwise maximum.  bucket_lo = 0 and
// nb_total = nb is the whole table, the launch without a window.
#include "common.cuh"

// lanes that share one (query, octant) probe, and threads a block
#define OL_LANES 8
#define OL_THREADS 128

#define OL_NONE 0xffffffffu

static __device__ __forceinline__ uint32_t so_bucket_scramble(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

// NV > 0: 16-byte vectors a lane, known when compiled (B = 4 * NV *
// OL_LANES); NV == 0: any B that is a multiple of 4.  The table is 16-byte
// aligned (kernels.octant_lookup refuses another) and is read as int4.
template <int NV>
__global__ void __launch_bounds__(OL_THREADS) octant_lookup_kernel(
    const int* __restrict__ keys, int nb, int B, int bucket_lo, int nb_total,
    const float* __restrict__ queries, int nq, float cell_size,
    int* __restrict__ out, long long keys_is, long long queries_is) {
  constexpr int L = OL_LANES;
  keys += blockIdx.y * keys_is;
  queries += blockIdx.y * queries_is;
  out += (size_t)blockIdx.y * nq * 8;
  // a warp serves 4 octants, two warps a query
  const int warp = (int)((blockIdx.x * OL_THREADS + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  const int qi = warp >> 1;
  if (qi >= nq) return;  // uniform per warp
  const int o = (warp & 1) * 4 + lane / L;
  const int sub = lane % L;

  uint32_t packed = 0;
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    const float s = __fdiv_rn(queries[qi * 3 + a], cell_size);
    const int c = (int)floorf(s);
    const float frac = s - (float)c;
    const int side = frac < 0.5f ? -1 : 1;
    const int nc = c + ((o >> (2 - a)) & 1) * side;
    packed |= ((uint32_t)nc & 1023u) << (10 * a);
  }
  const uint32_t b = so_bucket_scramble(packed) & (uint32_t)(nb_total - 1);
  // the same for every lane of the probe: a probe outside the window loads
  // nothing and still takes part in the reduction below
  const uint32_t local = b - (uint32_t)bucket_lo;
  const bool inside = local < (uint32_t)nb;
  const int4* row =
      reinterpret_cast<const int4*>(keys + (size_t)(inside ? local : 0) * B);
  const int key = (int)packed;
  const int nvec = B >> 2;  // 16-byte vectors in the row
  const int per_lane = NV > 0 ? NV : (nvec + L - 1) / L;
  // the lanes of this probe
  const uint32_t probe = ((1u << L) - 1u) << (lane - sub);

  // the lowest matching key index among this lane's vectors (the indices
  // grow with v, but the minimum keeps the loads independent of the
  // compares), then among the probe's lanes
  uint32_t mine = OL_NONE;
#pragma unroll(NV > 0 ? NV : 4)
  for (int v = 0; v < per_lane; ++v) {
    const int vi = v * L + sub;
    if (inside && (NV > 0 || vi < nvec)) {
      const int4 kv = row[vi];
      const uint32_t at = (uint32_t)vi * 4u;
      uint32_t hit = kv.w == key ? at + 3u : OL_NONE;
      hit = kv.z == key ? at + 2u : hit;
      hit = kv.y == key ? at + 1u : hit;
      hit = kv.x == key ? at : hit;
      mine = min(mine, hit);
    }
  }
  const uint32_t best = __reduce_min_sync(probe, mine);
  if (sub == 0)
    out[qi * 8 + o] = best != OL_NONE ? (int)(b * (uint32_t)B + best) : -1;
}

template <int NV>
static void so_launch_octant_lookup(const int* keys, int nb, int B,
                                    int bucket_lo, int nb_total,
                                    const float* queries, int nq,
                                    float cell_size, int* out, int n_inst,
                                    const long long* istride,
                                    cudaStream_t stream) {
  const long long threads = (long long)nq * 8 * OL_LANES;
  const dim3 blocks((unsigned)((threads + OL_THREADS - 1) / OL_THREADS),
                    (unsigned)n_inst);
  octant_lookup_kernel<NV><<<blocks, OL_THREADS, 0, stream>>>(
      keys, nb, B, bucket_lo, nb_total, queries, nq, cell_size, out,
      istride[0], istride[1]);
}

// nb and nb_total powers of two, the window [bucket_lo, bucket_lo + nb)
// inside [0, nb_total) and every global slot an int, B a multiple of 4,
// every instance's keys 16-byte aligned; istride (host) = {keys, queries}
// instance strides in elements.
extern "C" int so_octant_lookup(const int* keys, int nb, int B, int bucket_lo,
                                int nb_total, const float* queries, int nq,
                                float cell_size, int* out, int n_inst,
                                const long long* istride, void* stream) {
  if (nb < 1 || (nb & (nb - 1)) || nb_total < nb || (nb_total & (nb_total - 1)) ||
      bucket_lo < 0 || bucket_lo > nb_total - nb ||
      (long long)nb_total * B > 2147483647LL || B < 4 || (B & 3) ||
      (reinterpret_cast<uintptr_t>(keys) & 15) || (istride[0] & 3) ||
      n_inst < 1 || n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  if (nq > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (B == 128)  // 4 vectors a lane
      so_launch_octant_lookup<128 / (4 * OL_LANES)>(keys, nb, B, bucket_lo, nb_total, queries, nq, cell_size, out, n_inst, istride, s);
    else
      so_launch_octant_lookup<0>(keys, nb, B, bucket_lo, nb_total, queries, nq, cell_size, out, n_inst, istride, s);
  }
  return (int)cudaGetLastError();
}
