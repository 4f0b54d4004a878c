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
// What bounds it on an H100: bytes, not arithmetic.  Each (query, octant)
// reads one B = 128-key row (512 bytes); the key table itself is 256 KB
// (512 x 128 int32) and stays in the 50 MB L2, so the kernel is bound by
// L2 latency of 8 row reads per query.  Design: one warp per (query,
// octant), the row read coalesced as four 128-byte segments, the first
// match found with one ballot per segment and the scan stopped there.
#include "common.cuh"

static __device__ __forceinline__ uint32_t so_bucket_scramble(uint32_t h) {
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  return h;
}

__global__ void octant_lookup_kernel(const int* __restrict__ keys, int nb,
                                     int B, const float* __restrict__ queries,
                                     int nq, float cell_size,
                                     int* __restrict__ out) {
  const int warp = (int)((blockIdx.x * blockDim.x + threadIdx.x) >> 5);
  const int lane = threadIdx.x & 31;
  if (warp >= nq * 8) return;  // uniform per warp
  const int qi = warp >> 3, o = warp & 7;

  uint32_t packed = 0;
  for (int a = 0; a < 3; ++a) {
    const float s = __fdiv_rn(queries[qi * 3 + a], cell_size);
    const int c = (int)floorf(s);
    const float frac = s - (float)c;
    const int side = frac < 0.5f ? -1 : 1;
    const int nc = c + ((o >> (2 - a)) & 1) * side;
    packed |= ((uint32_t)nc & 1023u) << (10 * a);
  }
  const uint32_t b = so_bucket_scramble(packed) & (uint32_t)(nb - 1);
  const int* row = keys + (size_t)b * B;
  int found = -1;
  for (int base = 0; base < B; base += 32) {
    const int l = base + lane;
    const bool hit = l < B && row[l] == (int)packed;
    const unsigned bal = __ballot_sync(0xffffffffu, hit);
    if (bal) {
      found = base + __ffs(bal) - 1;
      break;
    }
  }
  if (lane == 0) out[qi * 8 + o] = found >= 0 ? (int)b * B + found : -1;
}

extern "C" int so_octant_lookup(const int* keys, int nb, int B,
                                const float* queries, int nq, float cell_size,
                                int* out, void* stream) {
  if (nq > 0) {
    const int threads = 256;  // 8 warps: one query's 8 octants per block
    const long long warps = (long long)nq * 8;
    const int blocks = (int)((warps * 32 + threads - 1) / threads);
    octant_lookup_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
        keys, nb, B, queries, nq, cell_size, out);
  }
  return (int)cudaGetLastError();
}
