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
// lane.  What costs is the claim table (T * 4 bytes, 0.5-2 MB an instance,
// 128 MB for a fleet of 64 at 2^19 slots) and the grid-wide order between
// filling it, claiming in it and reading it back.
//
// Design (T <= 2^19, every path): ONE launch, the table in distributed
// shared memory.  Each instance's table is split over one thread-block
// cluster of CS blocks: slot s belongs to block rank s >> (table_bits -
// log2 CS), at that offset in its dynamic shared memory (at most 2^15
// slots, 128 KB, a block; CS = 16 at 2^19, a non-portable cluster size).
// Each block fills its part with INT_MAX (16-byte stores); cluster barrier;
// each thread zeroes keep for its lanes (lane i in block i / 1,024 mod CS)
// and atomicMin's each masked lane into its slot's word, in its own
// block's shared memory or through cluster.map_shared_rank in another's;
// cluster barrier; each block reads its own part and sets keep for the
// lane each claimed slot holds — the lane that is masked and holds its
// slot's word, the contract's keep, since a lane claims one slot.  No block
// touches another's shared memory after the second barrier, so none waits
// for the others to leave.  Global memory holds xyz, mask, res and keep,
// and no scratch.  Integer atomicMin leaves the same winner whatever order
// the lanes arrive in, so the keep-mask is identical from run to run and
// to the plain version.  The cluster grows past what the table needs while
// its threads have lanes to share (vc_cluster_size): to 16 blocks for a
// launch of a few instances, to 8 for a fleet.
//
// What that costs on the H100 (PERF.md): the launch and the fill of a
// cluster take ~1.9 us and each cluster barrier ~0.7 us more, and the
// claims through distributed shared memory go at about one or two a clock
// a cluster.  So one instance, one cluster on at most 16 SMs, takes longer
// than the global form's three launches over the whole card, while a
// fleet, which fills the card with clusters and moves no table through L2
// or HBM, takes less.
//
// Larger tables (table_bits > 19, no path sizes one): the global form, a
// caller's scratch table of T int32 and three kernels back to back on one
// stream — fill, claim, compare — the stream's order being the grid-wide
// order the claim needs.  The dispatch is on table_bits alone.
//
// Instances: one launch serves n_inst independent scans (the batched step
// of superodom_tpu_torch/parallel.py).  Instance i is blockIdx.y (a
// cluster, or a row of the global form's grid): its points, mask and
// resolution start istride[0..2] elements after instance 0's (0: shared),
// its claim table is its own (its cluster's shared memory, or the i-th of
// n_inst global tables of T slots) and its keep-mask starts at i * N.  A
// lane claims only in its own instance's table, so each instance computes
// exactly what a launch on its own inputs computes, and n_inst = 1 is the
// single launch.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define VC_THREADS 256        // the global form's blocks
#define VC_CL_THREADS 1024    // the cluster form's blocks
#define VC_PART_MAX_BITS 15   // slots a block: 2^15 int32 = 128 KB
// 16 blocks a cluster at most (non-portable above 8)
#define VC_CLUSTER_MAX_BITS (VC_PART_MAX_BITS + 4)
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

// ------------------------------------------------------- the cluster form

// the word of slot s: in this block's part, or in another block's through
// distributed shared memory
static __device__ __forceinline__ int* vc_word(cg::cluster_group& cluster,
                                               int* part, uint32_t s,
                                               int part_bits,
                                               unsigned rank) {
  const unsigned owner = s >> part_bits;
  int* at = part + (s & ((1u << part_bits) - 1u));
  return owner == rank ? at : cluster.map_shared_rank(at, owner);
}

__global__ void __launch_bounds__(VC_CL_THREADS) vc_cluster_kernel(
    const float* __restrict__ xyz, const unsigned char* __restrict__ mask,
    int n, const float* __restrict__ res, int table_bits, int part_bits,
    unsigned char* __restrict__ keep, VcStrides is) {
  extern __shared__ int4 vc_part[];
  int* part = reinterpret_cast<int*>(vc_part);
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned b = blockIdx.y;
  xyz += b * is.s[0];
  mask += b * is.s[1];
  res += b * is.s[2];
  keep += (size_t)b * n;
  const unsigned rank = cluster.block_rank();

  for (int v = threadIdx.x; v < (1 << (part_bits - 2)); v += VC_CL_THREADS)
    vc_part[v] = make_int4(VC_INT_MAX, VC_INT_MAX, VC_INT_MAX, VC_INT_MAX);
  cluster.sync();

  const float r = *res;
  const uint32_t tmask = (1u << table_bits) - 1u;
  const int stride = (int)cluster.num_blocks() * VC_CL_THREADS;
  for (int i = (int)rank * VC_CL_THREADS + threadIdx.x; i < n; i += stride) {
    keep[i] = 0;
    if (mask[i])
      atomicMin(vc_word(cluster, part, vc_slot(xyz, i, r, tmask), part_bits,
                        rank),
                i);
  }
  // every claim is in, and every zero of keep is ordered before the ones
  cluster.sync();

  // each block marks the winners of its own part; no block reads another's
  // shared memory from here on
  for (int v = threadIdx.x; v < (1 << (part_bits - 2)); v += VC_CL_THREADS) {
    const int4 w = vc_part[v];
    if (w.x != VC_INT_MAX) keep[w.x] = 1;
    if (w.y != VC_INT_MAX) keep[w.y] = 1;
    if (w.z != VC_INT_MAX) keep[w.z] = 1;
    if (w.w != VC_INT_MAX) keep[w.w] = 1;
  }
}

// the cluster size for a table of 2^table_bits slots, n lanes and n_inst
// instances: as many blocks as the table needs at 2^15 slots a block, then
// more (at least 4 slots a block) — for a launch of at most VC_FEW
// instances, which fills few SMs whatever its clusters' size, up to 16
// while a block would have over 256 lanes; for a fleet, whose clusters
// fill the card, up to the portable 8 while a block would have over 2,048
#define VC_FEW 4
static int vc_cluster_size(int table_bits, int n, int n_inst) {
  const bool few = n_inst <= VC_FEW;
  const int max_lg = few ? 4 : 3;
  const long long per_block = few ? VC_CL_THREADS / 4 : 2 * VC_CL_THREADS;
  int lg = table_bits > VC_PART_MAX_BITS ? table_bits - VC_PART_MAX_BITS : 0;
  while (lg < max_lg && table_bits - lg > 2 && per_block << lg < n) ++lg;
  return 1 << lg;
}

// the kernel's attributes for every cluster shape, set once a device (the
// first launch on a card comes before any CUDA graph captures one)
static cudaError_t vc_attributes() {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess || dev < 0 || dev >= 64 || done[dev]) return e;
  e = cudaFuncSetAttribute(vc_cluster_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           4 << VC_PART_MAX_BITS);
  if (e == cudaSuccess)
    e = cudaFuncSetAttribute(vc_cluster_kernel,
                             cudaFuncAttributeNonPortableClusterSizeAllowed,
                             1);
  done[dev] = e == cudaSuccess;
  return e;
}

// the launch of the cluster form: its configuration on the current device
static cudaError_t vc_cluster_config(int table_bits, int n, int n_inst,
                                     cudaStream_t stream,
                                     cudaLaunchConfig_t* cfg,
                                     cudaLaunchAttribute* attr) {
  const int cs = vc_cluster_size(table_bits, n, n_inst);
  const size_t smem = (size_t)4 << (table_bits - __builtin_ctz(cs));
  const cudaError_t e = vc_attributes();
  *cfg = cudaLaunchConfig_t{};
  cfg->gridDim = dim3((unsigned)cs, (unsigned)n_inst);
  cfg->blockDim = dim3(VC_CL_THREADS);
  cfg->dynamicSmemBytes = smem;
  cfg->stream = stream;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = (unsigned)cs;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return e;
}

// -------------------------------------------------------- the global form

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

// ------------------------------------------------------------ the entries

// 4 <= table_bits <= 30.  table: for table_bits > 19 only (else unused, may
// be null), scratch of n_inst << table_bits int32, 16-byte aligned; every
// element is overwritten before it is read.  istride (host) = the instance
// strides, in elements, of xyz, mask and res.
extern "C" int so_voxel_claim(const float* xyz, const unsigned char* mask,
                              int n, const float* res, int table_bits,
                              int* table, unsigned char* keep, int n_inst,
                              const long long* istride, void* stream) {
  const bool global = table_bits > VC_CLUSTER_MAX_BITS;
  if (table_bits < 4 || table_bits > 30 || n < 0 || n_inst < 1 ||
      n_inst > 65535 ||
      (global && (table == nullptr ||
                  (reinterpret_cast<uintptr_t>(table) & 15) != 0)))
    return (int)cudaErrorInvalidValue;
  VcStrides is;
  for (int i = 0; i < 3; ++i) is.s[i] = istride[i];
  if (n == 0) return (int)cudaGetLastError();
  const cudaStream_t s = (cudaStream_t)stream;
  const uint32_t tmask = (1u << table_bits) - 1u;
  if (!global) {
    cudaLaunchConfig_t cfg;
    cudaLaunchAttribute attr;
    cudaError_t e = vc_cluster_config(table_bits, n, n_inst, s, &cfg, &attr);
    if (e != cudaSuccess) return (int)e;
    const int part_bits =
        table_bits - __builtin_ctz(cfg.gridDim.x);
    e = cudaLaunchKernelEx(&cfg, vc_cluster_kernel, xyz, mask, n, res,
                           table_bits, part_bits, keep, is);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
  }
  const int n_vec = 1 << (table_bits - 2);
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
  return (int)cudaGetLastError();
}

// The cluster form's shape for a table of 2^table_bits slots, n lanes and
// n_inst instances: out[0] = blocks a cluster, out[1] = shared memory bytes
// a block, out[2] = the clusters of that shape the current device can hold
// at once (cudaOccupancyMaxActiveClusters).  All 0 for the global form.
extern "C" int so_voxel_claim_clusters(int table_bits, int n, int n_inst,
                                       int* out) {
  out[0] = out[1] = out[2] = 0;
  if (table_bits < 4 || table_bits > 30 || n < 0 || n_inst < 1 ||
      n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  if (table_bits > VC_CLUSTER_MAX_BITS) return (int)cudaSuccess;
  cudaLaunchConfig_t cfg;
  cudaLaunchAttribute attr;
  cudaError_t e = vc_cluster_config(table_bits, n, n_inst, 0, &cfg, &attr);
  if (e != cudaSuccess) return (int)e;
  out[0] = (int)cfg.gridDim.x;
  out[1] = (int)cfg.dynamicSmemBytes;
  return (int)cudaOccupancyMaxActiveClusters(&out[2], vc_cluster_kernel,
                                             &cfg);
}
