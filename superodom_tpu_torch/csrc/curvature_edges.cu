// K11a curvature_edges — LOAM-style edge detection: the local curvature of
// every lane along its scan line, thresholded into a keep-mask.
//
// Replaces: superodom_tpu/frontend.py curvature_edge_extraction
// (:307-342).  Plain version: frontend.curvature_edge_extraction_reference.
//
// Per lane i of N, over the offsets -w..-1, +1..+w in that order, with the
// neighbour j = (i + off) mod N (the rolls WRAP: the first w lanes see the
// last w and the reverse):
//   same_j = ring[j] == ring[i] && mask[j];
//   acc    = acc + (same_j ? xyz[j] - xyz[i] : 0)   (a sequential sum);
//   curv   = |acc| / (2w * max(|xyz[i]|, 1e-6));
//   edge   = mask[i] && every same_j && curv > threshold
//            && |xyz[i]| > min_range.
// Norms are sqrt((x*x + y*y) + z*z); with --fmad=false and IEEE division
// the mask is the plain version's to the bit.
//
// What bounds it on an H100: instructions, then bytes.  18 bytes a lane
// (B = 64 OS1-128 scans: 151 MB, 45 us at 3.35 TB/s) against 12w
// additions a lane that must stay in the plain version's order (60 at
// w = 5), two square roots and an IEEE division.  The first design (one
// lane a thread) spent more on index arithmetic (two 64-bit modulos a
// staged lane), on the gate (five shared loads, a compare and three
// selects a neighbour) and on shared-memory traffic (12 bytes a
// neighbour a lane) than on the sum.  This design:
// - a tile of CE_TILE lanes a block, staged with its halo of w lanes a
//   side, every load of the tile in flight before the first store (loads
//   waited on one round trip after another took longer than the stencil);
//   an interior tile by 16-byte loads of its flat span (peeled to 16-byte
//   alignment: the base, an instance's stride and N need not be multiples
//   of 4), 32-bit offsets inside the tile; only an instance's first and
//   last tile wrap (one conditional add or subtract a lane, or the exact
//   modulo where N <= 2w and a window meets a lane twice);
// - the gate first: a warp's CE_R + 1 ballot words hold one bit a staged
//   position s, set when s and s + 1 are both live and on one ring, so
//   lane i passes iff the 2w bits of its window (a funnel shift of the two
//   words its window starts in) are all set (the chain of equal rings is
//   the same ring as i's; the window's masks include mask[i]).  A lane
//   that fails can never be an edge, so the sum needs no select, and only
//   a lane that passes takes its roots and division;
// - CE_R consecutive lanes a thread: the thread streams its window of
//   CE_R + 2w staged points once and adds each into the sums of the lanes
//   it neighbours, in offset order (the offsets are compile-time: one
//   instance a half window).  CE_R is odd, so a warp's reads at a stride
//   of 3 * CE_R words hit 32 banks.  3 rather than 5: more threads hide
//   one instance's latency (3.6 against 3.9 us at 131,072 lanes) for ~5%
//   more at B = 64; 1 is bound by shared-memory reads (1.5x at B = 64;
//   tools.kernel_ab, NVIDIA H100 80GB HBM3 at 700 W).
//
// Instances: one launch serves n_inst independent clouds of N lanes each
// (the batched step of superodom_tpu_torch/parallel.py).  Instance i is
// blockIdx.y: its points, rings and mask start istride[0..2] elements
// after instance 0's (0: shared), its mask out at i * N.  The halo wraps
// mod N inside the instance's own lanes, as jnp.roll does under jax.vmap:
// no lane reads a neighbouring instance.  n_inst = 1 is the single launch.
#include <limits.h>
#include <math.h>

#include "common.cuh"

#define CE_R 3                        // lanes a thread (odd: no bank conflict)
#define CE_THREADS 128
#define CE_MIN_BLOCKS 12              // blocks an SM: at most 42 registers
#define CE_TILE (CE_R * CE_THREADS)   // lanes a block
#define CE_MAX_HW 16                  // the largest half window
#define CE_SPAN (CE_TILE + 2 * CE_MAX_HW)  // staged positions, at most

// the instance strides of xyz, ring and mask, in elements
struct CeStrides {
  long long s[3];
};

// A copy of src[0, count) into shared dst[lead + e] in two steps, so that
// every load of a tile is in flight before the first store: load() reads
// the 16-byte words of the span (at most K a thread) and its unaligned
// head and tail elements (fewer than 16 / sizeof(E): at most one a
// thread) into registers, store() writes them; lead = src's misalignment
// in elements, so that dst (16-byte aligned) shares src's alignment.
template <typename E, int K>
struct CeStage {
  static constexpr int V = 16 / sizeof(E);
  uint4 v[K];
  E h, t;
  int lead, head, nvec, tail, count;

  __device__ __forceinline__ void load(const E* __restrict__ src, int n) {
    const int i = (int)threadIdx.x;
    count = n;
    lead = (int)(((uintptr_t)src & 15) / sizeof(E));
    head = min(count, (V - lead) % V);
    nvec = (count - head) / V;
    tail = head + nvec * V;
    if (i < head) h = src[i];
    if (tail + i < count) t = src[tail + i];
    const uint4* vs = reinterpret_cast<const uint4*>(src + head);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (i + k * CE_THREADS < nvec) v[k] = vs[i + k * CE_THREADS];
  }

  __device__ __forceinline__ void store(E* dst) const {
    const int i = (int)threadIdx.x;
    if (i < head) dst[lead + i] = h;
    if (tail + i < count) dst[lead + tail + i] = t;
    uint4* vd = reinterpret_cast<uint4*>(dst + lead + head);
#pragma unroll
    for (int k = 0; k < K; ++k)
      if (i + k * CE_THREADS < nvec) vd[i + k * CE_THREADS] = v[k];
  }
};

// 16-byte words a thread at most: a span of CE_SPAN elements of E
#define CE_WORDS_OF(E) \
  ((CE_SPAN * (int)sizeof(E) / 16 + 1 + CE_THREADS - 1) / CE_THREADS)
// staged positions a thread at most (a tile that wraps)
#define CE_POS (CE_SPAN / CE_THREADS + 1)

template <int HW>
__global__ void __launch_bounds__(CE_THREADS, CE_MIN_BLOCKS)
    curvature_edges_kernel(const float* __restrict__ xyz,
                           const int* __restrict__ ring,
                           const unsigned char* __restrict__ mask, int n,
                           float den_scale, float threshold, float min_range,
                           unsigned char* __restrict__ out, CeStrides is) {
  {
    const unsigned b = blockIdx.y;
    xyz += b * is.s[0];
    ring += b * is.s[1];
    mask += b * is.s[2];
    out += (size_t)b * n;
  }
  __shared__ __align__(16) float sx[3 * CE_SPAN + 4];
  __shared__ __align__(16) int sr[CE_SPAN + 4];
  __shared__ __align__(16) unsigned char sm[CE_SPAN + 16];

  const int base = (int)blockIdx.x * CE_TILE;
  const int tn = min(CE_TILE, n - base);  // lanes of this tile
  const int span = tn + 2 * HW;           // staged positions
  const int g0 = base - HW;               // lane of staged position 0
  int dx = 0, dr = 0, dm = 0;             // each array's lead in shared
  if (g0 >= 0 && g0 + span <= n) {
    CeStage<float, CE_WORDS_OF(float[3])> cx;
    CeStage<int, CE_WORDS_OF(int)> cr;
    CeStage<unsigned char, CE_WORDS_OF(unsigned char)> cm;
    cx.load(xyz + 3 * (long long)g0, 3 * span);
    cr.load(ring + g0, span);
    cm.load(mask + g0, span);
    cx.store(sx);
    cr.store(sr);
    cm.store(sm);
    dx = cx.lead;
    dr = cr.lead;
    dm = cm.lead;
  } else {  // an instance's first or last tile: the halo wraps
    float px[CE_POS][3];
    int pr[CE_POS];
    unsigned char pm[CE_POS];
#pragma unroll
    for (int k = 0; k < CE_POS; ++k) {
      const int s = (int)threadIdx.x + k * CE_THREADS;
      if (s < span) {
        const int g = g0 + s;
        const int j = n > 2 * HW ? (g < 0 ? g + n : (g >= n ? g - n : g))
                                 : ((g % n) + n) % n;
        const float* p = xyz + 3 * (size_t)j;
        px[k][0] = p[0];
        px[k][1] = p[1];
        px[k][2] = p[2];
        pr[k] = ring[j];
        pm[k] = mask[j];
      }
    }
#pragma unroll
    for (int k = 0; k < CE_POS; ++k) {
      const int s = (int)threadIdx.x + k * CE_THREADS;
      if (s < span) {
        sx[3 * s] = px[k][0];
        sx[3 * s + 1] = px[k][1];
        sx[3 * s + 2] = px[k][2];
        sr[s] = pr[k];
        sm[s] = pm[k];
      }
    }
  }
  __syncthreads();

  // the gate, a warp at a time: the warp's windows lie in its CE_R + 1
  // words from word CE_R * warp on; bit l of word j (lane j keeps it) says
  // that staged positions s = 32 (CE_R * warp + j) + l and s + 1 are live
  // and on one ring
  const int lane = (int)(threadIdx.x & 31);
  const int wb = CE_R * (int)(threadIdx.x >> 5);
  unsigned word = 0;
#pragma unroll
  for (int j = 0; j <= CE_R; ++j) {
    const int s = 32 * (wb + j) + lane;
    const bool q = s + 1 < span && sm[dm + s] != 0 && sm[dm + s + 1] != 0 &&
                   sr[dr + s] == sr[dr + s + 1];
    const unsigned w = __ballot_sync(0xffffffffu, q);
    if (lane == j) word = w;
  }

  // thread t: lanes base + R t + r, r < R; its window starts at staged
  // position R t (lane r's centre is R t + r + HW)
  const int t0 = CE_R * (int)threadIdx.x;
  const float* win = sx + dx + 3 * t0;
  constexpr unsigned all = (unsigned)((1ull << (2 * HW)) - 1);
  float p[CE_R][3], rng[CE_R];
  bool live[CE_R];
  bool any = false;
#pragma unroll
  for (int r = 0; r < CE_R; ++r) {
    const int a = t0 + r;  // the window's first position
    const int i = (a >> 5) - wb;
    const unsigned bits = __funnelshift_r(__shfl_sync(0xffffffffu, word, i),
                                          __shfl_sync(0xffffffffu, word, i + 1),
                                          (unsigned)a & 31);
#pragma unroll
    for (int c = 0; c < 3; ++c) p[r][c] = win[3 * (r + HW) + c];
    rng[r] = sqrtf(so_dot3(p[r], p[r]));
    live[r] = a < tn && (bits & all) == all && rng[r] > min_range;
    any = any || live[r];
  }
  if (any) {
    float acc[CE_R][3];
#pragma unroll
    for (int r = 0; r < CE_R; ++r) acc[r][0] = acc[r][1] = acc[r][2] = 0.0f;
#pragma unroll
    for (int k = 0; k < CE_R + 2 * HW; ++k) {
      const float q[3] = {win[3 * k], win[3 * k + 1], win[3 * k + 2]};
#pragma unroll
      for (int r = 0; r < CE_R; ++r) {
        const int off = k - r - HW;  // ascending for each lane
        if (off != 0 && off >= -HW && off <= HW) {
#pragma unroll
          for (int c = 0; c < 3; ++c) acc[r][c] = acc[r][c] + (q[c] - p[r][c]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < CE_R; ++r)
      if (live[r])
        live[r] = sqrtf(so_dot3(acc[r], acc[r])) /
                      (den_scale * so_clamp_min(rng[r], 1e-6f)) >
                  threshold;
  }
#pragma unroll
  for (int r = 0; r < CE_R; ++r)
    if (t0 + r < tn) out[base + t0 + r] = live[r] ? 1 : 0;
}

using CeKernel = decltype(&curvature_edges_kernel<1>);

// one kernel a half window: the stencil's offsets are compile-time
static const CeKernel* ce_kernels() {
  static const CeKernel k[CE_MAX_HW] = {
      curvature_edges_kernel<1>,  curvature_edges_kernel<2>,
      curvature_edges_kernel<3>,  curvature_edges_kernel<4>,
      curvature_edges_kernel<5>,  curvature_edges_kernel<6>,
      curvature_edges_kernel<7>,  curvature_edges_kernel<8>,
      curvature_edges_kernel<9>,  curvature_edges_kernel<10>,
      curvature_edges_kernel<11>, curvature_edges_kernel<12>,
      curvature_edges_kernel<13>, curvature_edges_kernel<14>,
      curvature_edges_kernel<15>, curvature_edges_kernel<16>};
  return k;
}

// den_scale = 2 * half_window, rounded to float as the plain version's
// Python scalar is.  istride (host) = the instance strides, in elements,
// of xyz, ring and mask.  n < INT_MAX - 2 * CE_TILE keeps every lane
// offset of a tile in 32 bits.
extern "C" int so_curvature_edges(const float* xyz, const int* ring,
                                  const unsigned char* mask, int n, int hw,
                                  float den_scale, float threshold,
                                  float min_range, unsigned char* out,
                                  int n_inst, const long long* istride,
                                  void* stream) {
  if (hw < 1 || hw > CE_MAX_HW || n < 0 || n > INT_MAX - 2 * CE_TILE ||
      n_inst < 1 || n_inst > 65535)
    return (int)cudaErrorInvalidValue;
  CeStrides is;
  for (int i = 0; i < 3; ++i) is.s[i] = istride[i];
  if (n > 0) {
    const dim3 blocks((unsigned)((n + CE_TILE - 1) / CE_TILE),
                      (unsigned)n_inst);
    const CeKernel kernel = ce_kernels()[hw - 1];
    kernel<<<blocks, CE_THREADS, 0, (cudaStream_t)stream>>>(
        xyz, ring, mask, n, den_scale, threshold, min_range, out, is);
  }
  return (int)cudaGetLastError();
}
