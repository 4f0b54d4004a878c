// K10 voxel_claim — scatter-claim voxel thinning of a scan: of the masked
// lanes that fall into one slot of a hash table over res-sized voxels, the
// lowest lane survives.
//
// Replaces: superodom_tpu/ops/voxel.py voxel_downsample_scatter (:110-134)
// with its voxel_coords (:28-30) and hash_coords (:42-46).  Plain version:
// ops/voxel.voxel_downsample_scatter_reference.
//
// Contract: slot = fmix32(cx*P1 + cy*P2 + cz*P3 + seed) & (T-1) over
// c = floor(xyz / res) (the IEEE quotient, uint32 wrap-around arithmetic);
// table[T] of int32 starts at INT_MAX; every masked lane takes
// min(table[slot], lane); keep = mask & (table[slot] == lane).  res is
// read from device memory: it may change from scan to scan and the caller
// never reads it on the host.
//
// What bounds it on an H100: nothing the card is short of.  The function
// moves 14 bytes a lane (N <= 43,691: 0.6 MB) and ~40 integer operations a
// lane; the table (T * 4 bytes, 0.5-2 MB) is scratch that stays in L2.
// What costs is three dependent passes — fill, claim, compare — each
// shorter than its launch: the three kernels go out back to back on one
// stream, which is the grid-wide order the claim needs before the compare.
// Integer atomicMin gives the same table whatever order the lanes arrive
// in, so the keep-mask is identical from run to run.  Design: one thread a
// lane, the slot recomputed in the compare pass rather than staged in
// memory, the table filled with 16-byte stores.
//
// Instances: one launch of each pass serves n_inst independent scans (the
// batched step of superodom_tpu_torch/parallel.py).  Instance i is
// blockIdx.y: its points, mask and resolution start istride[0..2]
// elements after instance 0's (0: shared), its claim table is the i-th of
// n_inst tables of T slots and its keep-mask starts at i * N.  A lane
// claims only in its own instance's table, so each instance computes
// exactly what a launch on its own inputs computes, and n_inst = 1 is the
// single launch.
#include "common.cuh"

#define VC_THREADS 256
#define VC_INT_MAX 2147483647

// the instance strides of xyz, mask and res, in elements
struct VcStrides {
  long long s[3];
};

static __device__ __forceinline__ uint32_t vc_slot(
    const float* __restrict__ xyz, int i, float res, uint32_t tmask) {
  const uint32_t cx = (uint32_t)(int)floorf(__fdiv_rn(xyz[3 * i + 0], res));
  const uint32_t cy = (uint32_t)(int)floorf(__fdiv_rn(xyz[3 * i + 1], res));
  const uint32_t cz = (uint32_t)(int)floorf(__fdiv_rn(xyz[3 * i + 2], res));
  uint32_t h = cx * 73856093u + cy * 19349663u + cz * 83492791u + 0x9E3779B9u;
  h ^= h >> 16;
  h *= 0x85EBCA6Bu;
  h ^= h >> 13;
  h *= 0xC2B2AE35u;
  h ^= h >> 16;
  return h & tmask;
}

// T is a power of two >= 16 and the tables are 16-byte aligned; n_vec =
// T / 4 vectors a table
__global__ void __launch_bounds__(VC_THREADS) vc_fill_kernel(
    int4* __restrict__ table, int n_vec) {
  const int i = blockIdx.x * VC_THREADS + threadIdx.x;
  if (i < n_vec)
    table[(size_t)blockIdx.y * n_vec + i] =
        make_int4(VC_INT_MAX, VC_INT_MAX, VC_INT_MAX, VC_INT_MAX);
}

__global__ void __launch_bounds__(VC_THREADS) vc_claim_kernel(
    const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
    int n, const float* __restrict__ res, uint32_t tmask,
    int* __restrict__ table, VcStrides is) {
  const unsigned b = blockIdx.y;
  xyz += b * is.s[0];
  mask += b * is.s[1];
  res += b * is.s[2];
  table += (size_t)b * (tmask + 1u);
  const int i = blockIdx.x * VC_THREADS + threadIdx.x;
  if (i < n && mask[i]) atomicMin(table + vc_slot(xyz, i, *res, tmask), i);
}

__global__ void __launch_bounds__(VC_THREADS) vc_keep_kernel(
    const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
    int n, const float* __restrict__ res, uint32_t tmask,
    const int* __restrict__ table, unsigned char* __restrict__ keep,
    VcStrides is) {
  const unsigned b = blockIdx.y;
  xyz += b * is.s[0];
  mask += b * is.s[1];
  res += b * is.s[2];
  table += (size_t)b * (tmask + 1u);
  keep += (size_t)b * n;
  const int i = blockIdx.x * VC_THREADS + threadIdx.x;
  if (i >= n) return;
  keep[i] = mask[i] && table[vc_slot(xyz, i, *res, tmask)] == i;
}

// table: scratch of n_inst << table_bits int32 (4 <= table_bits <= 30),
// 16-byte aligned; every element is overwritten before it is read.
// istride (host) = the instance strides, in elements, of xyz, mask and res.
extern "C" int so_voxel_claim(const float* xyz, const unsigned char* mask,
                              int n, const float* res, int table_bits,
                              int* table, unsigned char* keep, int n_inst,
                              const long long* istride, void* stream) {
  if (table_bits < 4 || table_bits > 30 || n < 0 || n_inst < 1 ||
      n_inst > 65535 || (reinterpret_cast<uintptr_t>(table) & 15) != 0)
    return (int)cudaErrorInvalidValue;
  VcStrides is;
  for (int i = 0; i < 3; ++i) is.s[i] = istride[i];
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    const int n_vec = 1 << (table_bits - 2);
    const uint32_t tmask = (1u << table_bits) - 1u;
    const dim3 fill((unsigned)((n_vec + VC_THREADS - 1) / VC_THREADS),
                    (unsigned)n_inst);
    const dim3 blocks((unsigned)((n + VC_THREADS - 1) / VC_THREADS),
                      (unsigned)n_inst);
    vc_fill_kernel<<<fill, VC_THREADS, 0, s>>>(reinterpret_cast<int4*>(table),
                                               n_vec);
    vc_claim_kernel<<<blocks, VC_THREADS, 0, s>>>(xyz, mask, n, res, tmask,
                                                  table, is);
    vc_keep_kernel<<<blocks, VC_THREADS, 0, s>>>(xyz, mask, n, res, tmask,
                                                 table, keep, is);
  }
  return (int)cudaGetLastError();
}
