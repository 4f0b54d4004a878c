// K4 gn_solve / normal_system — the damped robust Gauss-Newton solve of
// one ICP round on SE(3), all of its iterations in ONE launch.
//
// Replaces: superodom_tpu/registration.py gauss_newton_solve (:530-650)
// with its _accumulate_normal_system (:463-527, planes and edges) and
// _tukey_weight (:455-460).  Plain version:
// registration.gauss_newton_solve_reference (and normal_system_reference
// for the n_iters = 0 mode).
//
// Each iteration, for the fixed correspondences of the round:
//   1. per plane row m: wp = R p + t, r = n.wp + d, J = [n, wp x n],
//      w = valid * coeff * Tukey(r^2; a_sq); sum w J J^T, w J r, w r^2;
//      per edge row e (line through a and b, d = a - b):
//      we = R p + t, r_e = (we - a) x (we - b) / |d| (3 residuals),
//      J_e = skew(-d/|d|) [I, -skew(we)], w = valid * coeff *
//      Tukey(|r_e|^2; a_sq_e); sum w J_e^T J_e, w J_e^T r_e, w |r_e|^2;
//   2. the pose prior's diagonal and residual (if a prior is given);
//   3. Hd = H + damping * I * (1 + diag H);
//   4. delta = -Hd^-1 g by the column Cholesky of ops/smallsolve.py
//      (_chol6 / _chol_solve), op for op; a non-finite delta becomes 0;
//   5. the axis hold: the translation along held BODY axes of the current
//      q is removed;
//   6. the left-multiplicative retraction exp(delta) * pose, then
//      quat_normalize; |delta| < 1e-6 of the first iteration is reported.
// The hold mask is computed once, in iteration 0, at the round's start
// pose: the per-axis votes (obs_bins[:, 2] - 6 of each valid plane; each
// valid edge votes for every body axis with 1 - (d/|d| . axis)^2 > 0.5)
// and the valid count (planes and edges) are four more sums of the same
// reduction, and the threshold is registration.axis_hold_mask's.
// With n_iters = 0 the kernel instead returns (H, g, cost) at the given
// pose: 36 + 6 + 1 floats, H in full (the final-H call of icp_register).
//
// What bounds it on an H100: not bytes (~68 KB at M = 2,048 plane rows, ~21
// KB more at 512 edge rows) and not flops (~100 a plane row and ~250 an
// edge row an iteration), but latency — the launch, and per
// iteration a reduction across the card followed by a serial 6x6 solve.
// Design: one thread-block cluster of 8 blocks x 256 threads (it measured
// faster on the H100 than one block of 1,024; PERF.md).  Each block stages
// its fixed contiguous slice of the plane rows and of the edge rows into
// shared memory ONCE with bulk
// asynchronous copies (cp.async.bulk, completion on an mbarrier); every
// iteration then reads shared memory only.  Per-block partials come from
// warp shuffles, combined across warps in a fixed order; after a cluster
// barrier, rank 0 reads the blocks' partials from distributed shared
// memory in rank order, one thread solves, and writes the new pose to its
// shared memory; after a second barrier every block reads it back.  No
// float atomics: repeated runs are bit-identical.  The host pays one
// launch per ICP round instead of ~100 small ops per GN iteration.
//
// Instances: one launch serves n_inst independent solves (the batched step
// of superodom_tpu_torch/parallel.py) on a grid of (GN_BLOCKS, n_inst)
// blocks, one cluster per instance: instance i is blockIdx.y, its inputs
// start istride[...] elements after instance 0's (0: shared), its outputs
// follow at i * 43 or i * 7 (and i for first_small).  The cluster, its
// staging and its reduction through distributed shared memory are the
// single launch's, so each instance computes exactly what a launch on its
// own inputs computes, and n_inst = 1 is the single launch.
#include <cooperative_groups.h>
#include <math.h>

#include "common.cuh"

namespace cg = cooperative_groups;

#define GN_ACC 32        // 21 H (upper triangle) + 6 g + cost + 3 votes + valid
#define GN_ROW_BYTES 33  // p_body 12 + normal 12 + d 4 + coeff 4 + valid 1
#define GN_EDGE_ROW_BYTES 41  // p_body 12 + a 12 + b 12 + coeff 4 + valid 1
#define GN_MAX_DYN_SMEM (216 * 1024)  // of the 227 KB a block may use
#define GN_BLOCKS 8      // the blocks of the one cluster
#define GN_THREADS 256   // threads a block
#define GN_INPUTS 20     // the per-instance inputs, in so_gn_solve's order

struct GnArgs {
  const float* p_body;
  const float* normal;
  const float* d;
  const float* coeff;
  const unsigned char* valid;
  const int* obs_bins;  // [nm, 3]; read only when hold_min > 0
  int nm;
  int rows;  // plane rows staged per block (a multiple of 16)
  const float* e_p;  // edge rows [ne, 3]; null when ne = 0
  const float* e_a;
  const float* e_b;
  const float* e_coeff;
  const unsigned char* e_valid;
  int ne;
  int erows;  // edge rows staged per block (a multiple of 16)
  const float* a_sq_e;  // the edges' Tukey support; read when ne > 0
  const float* q0;
  const float* t0;
  const float* a_sq;
  const float* prior_q;  // null: no prior
  const float* prior_t;
  const float* prior_info;
  const unsigned char* prior_enabled;
  const unsigned char* hold_enabled;  // null: armed
  int hold_min;                       // 0: no hold
  float hold_frac;
  float damping;
  int n_iters;
  float* out;  // n_iters = 0: H[36], g[6], cost; else q[4], t[3]
  unsigned char* first_small;
  long long is[GN_INPUTS];  // the inputs' instance strides, in elements
};

// p + i * s, a null pointer kept null
template <typename T>
static __device__ __forceinline__ T* so_at(T* p, long long s, unsigned i) {
  return p != nullptr ? p + i * s : p;
}

// The arguments of instance i: every input at its instance stride (in
// so_gn_solve's order), the outputs at the instance's place.
static __device__ GnArgs gn_instance(GnArgs a, unsigned i) {
  a.p_body = so_at(a.p_body, a.is[0], i);
  a.normal = so_at(a.normal, a.is[1], i);
  a.d = so_at(a.d, a.is[2], i);
  a.coeff = so_at(a.coeff, a.is[3], i);
  a.valid = so_at(a.valid, a.is[4], i);
  a.obs_bins = so_at(a.obs_bins, a.is[5], i);
  a.q0 = so_at(a.q0, a.is[6], i);
  a.t0 = so_at(a.t0, a.is[7], i);
  a.a_sq = so_at(a.a_sq, a.is[8], i);
  a.prior_q = so_at(a.prior_q, a.is[9], i);
  a.prior_t = so_at(a.prior_t, a.is[10], i);
  a.prior_info = so_at(a.prior_info, a.is[11], i);
  a.prior_enabled = so_at(a.prior_enabled, a.is[12], i);
  a.hold_enabled = so_at(a.hold_enabled, a.is[13], i);
  a.e_p = so_at(a.e_p, a.is[14], i);
  a.e_a = so_at(a.e_a, a.is[15], i);
  a.e_b = so_at(a.e_b, a.is[16], i);
  a.e_coeff = so_at(a.e_coeff, a.is[17], i);
  a.e_valid = so_at(a.e_valid, a.is[18], i);
  a.a_sq_e = so_at(a.a_sq_e, a.is[19], i);
  a.out = so_at(a.out, a.n_iters > 0 ? 7 : 43, i);
  a.first_small = so_at(a.first_small, 1, i);
  return a;
}

// ---------------------------------------------------------------- mbarrier

static __device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

static __device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(bar))
               : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

static __device__ __forceinline__ void mbar_expect_tx(unsigned long long* bar,
                                                      unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   smem_addr(bar)),
               "r"(bytes)
               : "memory");
}

static __device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                                 unsigned parity) {
  unsigned done = 0;
  do {
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

static __device__ __forceinline__ void bulk_copy(void* dst, const void* src,
                                                 unsigned bytes,
                                                 unsigned long long* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];" ::"r"(smem_addr(dst)),
      "l"(src), "r"(bytes), "r"(smem_addr(bar))
      : "memory");
}

// Bytes of [src, src + bytes) the bulk engine takes: a 16-byte aligned
// source, whole 16-byte units.  The threads copy the rest.
static __device__ __forceinline__ unsigned bulk_head(const void* src,
                                                     unsigned bytes) {
  return ((reinterpret_cast<uintptr_t>(src) & 15u) == 0) ? (bytes & ~15u)
                                                         : 0u;
}

// ------------------------------------------------------------ small math

// Hamilton product a*b — geometry.quat_mul, op for op
static __device__ __forceinline__ void so_quat_mul(const float a[4],
                                                   const float b[4],
                                                   float out[4]) {
  out[0] = a[0] * b[0] - a[1] * b[1] - a[2] * b[2] - a[3] * b[3];
  out[1] = a[0] * b[1] + a[1] * b[0] + a[2] * b[3] - a[3] * b[2];
  out[2] = a[0] * b[2] - a[1] * b[3] + a[2] * b[0] + a[3] * b[1];
  out[3] = a[0] * b[3] + a[1] * b[2] - a[2] * b[1] + a[3] * b[0];
}

// One GN update of (q, t) from the reduced sums: prior, damping, Cholesky
// solve, finite guard, axis hold, retraction.  Returns |delta| < 1e-6.
static __device__ bool gn_update(const float* tot, const GnArgs& a,
                                 const bool hold[3], float q[4], float t[3]) {
  float H[6][6], g[6];
  int v = 0;
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = i; j < 6; ++j) H[i][j] = H[j][i] = tot[v++];
#pragma unroll
  for (int i = 0; i < 6; ++i) g[i] = tot[21 + i];

  if (a.prior_q != nullptr) {
    const float pc[4] = {a.prior_q[0], -a.prior_q[1], -a.prior_q[2],
                         -a.prior_q[3]};
    float dq[4];
    so_quat_mul(pc, q, dq);
    const float r6[6] = {t[0] - a.prior_t[0], t[1] - a.prior_t[1],
                         t[2] - a.prior_t[2], 2.0f * dq[1],
                         2.0f * dq[2],        2.0f * dq[3]};
    const float en = a.prior_enabled[0] ? 1.0f : 0.0f;
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      const float lam = a.prior_info[i] * en;
      H[i][i] = H[i][i] + lam;
      g[i] = g[i] + lam * r6[i];
    }
  }

  // Hd = H + damping * eye * (1 + diag H), element for element
  float Hd[6][6];
#pragma unroll
  for (int i = 0; i < 6; ++i)
#pragma unroll
    for (int j = 0; j < 6; ++j)
      Hd[i][j] = H[i][j] + (i == j ? a.damping : 0.0f) * (1.0f + H[j][j]);

  // _chol6: column by column
  float L[6][6];
#pragma unroll
  for (int j = 0; j < 6; ++j) {
    float col[6];
#pragma unroll
    for (int i = 0; i < 6; ++i) {
      col[i] = Hd[i][j];
      if (j > 0) {
        float s = L[i][0] * L[j][0];
#pragma unroll
        for (int k = 1; k < j; ++k) s = s + L[i][k] * L[j][k];
        col[i] = col[i] - s;
      }
    }
    const float dj = sqrtf(so_clamp_min(col[j], 1e-12f));
#pragma unroll
    for (int i = 0; i < 6; ++i)
      L[i][j] = i > j ? col[i] / dj : (i == j ? dj : 0.0f);
  }
  // _chol_solve: forward, then backward substitution
  float y[6], x[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    float s = g[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - L[i][k] * y[k];
    y[i] = s / L[i][i];
  }
#pragma unroll
  for (int i = 5; i >= 0; --i) {
    float s = y[i];
#pragma unroll
    for (int k = i + 1; k < 6; ++k) s = s - L[k][i] * x[k];
    x[i] = s / L[i][i];
  }
  float dl[6];
#pragma unroll
  for (int i = 0; i < 6; ++i) {
    const float di = -x[i];
    dl[i] = isfinite(di) ? di : 0.0f;
  }

  if (a.hold_min > 0) {
    // body axes (rows) = quat_rotate(q, e_i); dt -= axes^T (hold * axes dt)
    float ax[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      const float e[3] = {i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f,
                          i == 2 ? 1.0f : 0.0f};
      so_quat_rotate(q, e, ax[i]);
    }
    float h[3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
      h[i] = (hold[i] ? 1.0f : 0.0f) *
             (ax[i][0] * dl[0] + ax[i][1] * dl[1] + ax[i][2] * dl[2]);
    float dt[3];
#pragma unroll
    for (int j = 0; j < 3; ++j)
      dt[j] = dl[j] - (ax[0][j] * h[0] + ax[1][j] * h[1] + ax[2][j] * h[2]);
#pragma unroll
    for (int j = 0; j < 3; ++j) dl[j] = dt[j];
  }

  // se3_exp(delta): dq = so3_exp(omega), dt = V(omega) ups
  const float om[3] = {dl[3], dl[4], dl[5]};
  const float th_sq = om[0] * om[0] + om[1] * om[1] + om[2] * om[2];
  const float th = sqrtf(th_sq + 1e-24f);
  const float half = 0.5f * th;
  const bool small = th_sq < 1e-10f;
  const float imag = small ? 0.5f - th_sq / 48.0f : sinf(half) / th;
  const float dq[4] = {cosf(half), imag * om[0], imag * om[1], imag * om[2]};
  const float ca = small ? 0.5f : (1.0f - cosf(th)) / th_sq;
  const float cb = small ? 1.0f / 6.0f : (th - sinf(th)) / (th_sq * th);
  const float Om[3][3] = {
      {0.0f, -om[2], om[1]}, {om[2], 0.0f, -om[0]}, {-om[1], om[0], 0.0f}};
  float dtr[3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    float V[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      const float eye = i == j ? 1.0f : 0.0f;
      const float Om2 = om[i] * om[j] - th_sq * eye;
      V[j] = (eye + ca * Om[i][j]) + cb * Om2;
    }
    dtr[i] = V[0] * dl[0] + V[1] * dl[1] + V[2] * dl[2];
  }

  // pose' = (normalize(dq * q), rotate(dq, t) + dt)
  float qn[4], tn[3];
  so_quat_mul(dq, q, qn);
  const float nrm =
      sqrtf(qn[0] * qn[0] + qn[1] * qn[1] + qn[2] * qn[2] + qn[3] * qn[3]);
  const float den = so_clamp_min(nrm, 1e-8f);
  const float sgn = qn[0] / den < 0.0f ? -1.0f : 1.0f;
#pragma unroll
  for (int i = 0; i < 4; ++i) q[i] = (qn[i] / den) * sgn;
  so_quat_rotate(dq, t, tn);
#pragma unroll
  for (int i = 0; i < 3; ++i) t[i] = tn[i] + dtr[i];

  float dn = 0.0f;
#pragma unroll
  for (int i = 0; i < 6; ++i) dn = dn + dl[i] * dl[i];
  return sqrtf(dn) < 1e-6f;
}

// ------------------------------------------------------------------ kernel

__global__ void __cluster_dims__(GN_BLOCKS, 1, 1)
    __launch_bounds__(GN_THREADS) gn_kernel(const GnArgs args) {
  constexpr int NT = GN_THREADS;
  const GnArgs a = gn_instance(args, blockIdx.y);
  cg::cluster_group cluster = cg::this_cluster();
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ float warp_part[NT / 32][GN_ACC];
  __shared__ float block_part[GN_ACC];
  __shared__ float tot[GN_ACC];
  __shared__ float pose_sh[8];
  __shared__ __align__(8) unsigned long long bar;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int rank = blockIdx.x;  // the grid's x is one cluster
  const int r0 = rank * a.rows;
  const int n = max(0, min(a.rows, a.nm - r0));
  const int e0 = rank * a.erows;
  const int ne = max(0, min(a.erows, a.ne - e0));

  // ---- stage this block's rows once: bulk copies + a byte tail each; the
  // edge rows follow the plane rows (both counts are multiples of 16, so
  // every array starts on a 16-byte line)
  float* sp = reinterpret_cast<float*>(smem);
  float* sn = sp + 3 * a.rows;
  float* sd = sn + 3 * a.rows;
  float* sc = sd + a.rows;
  unsigned char* sv = reinterpret_cast<unsigned char*>(sc + a.rows);
  float* ep = reinterpret_cast<float*>(smem + (size_t)a.rows * GN_ROW_BYTES);
  float* ea = ep + 3 * a.erows;
  float* eb = ea + 3 * a.erows;
  float* ec = eb + 3 * a.erows;
  unsigned char* ev = reinterpret_cast<unsigned char*>(ec + a.erows);
  void* dst[10] = {sp, sn, sd, sc, sv, ep, ea, eb, ec, ev};
  const bool edges = a.ne > 0;
  const void* src[10] = {
      a.p_body + 3 * r0, a.normal + 3 * r0, a.d + r0, a.coeff + r0,
      a.valid + r0,
      edges ? a.e_p + 3 * e0 : nullptr, edges ? a.e_a + 3 * e0 : nullptr,
      edges ? a.e_b + 3 * e0 : nullptr, edges ? a.e_coeff + e0 : nullptr,
      edges ? a.e_valid + e0 : nullptr};
  const unsigned bytes[10] = {12u * n,  12u * n,  4u * n,  4u * n,
                              1u * n,   12u * ne, 12u * ne, 12u * ne,
                              4u * ne,  1u * ne};
  if (tid == 0) mbar_init(&bar);
  __syncthreads();
  if (tid == 0) {
    unsigned tx = 0;
#pragma unroll
    for (int i = 0; i < 10; ++i) tx += bulk_head(src[i], bytes[i]);
    mbar_expect_tx(&bar, tx);
#pragma unroll
    for (int i = 0; i < 10; ++i) {
      const unsigned head = bulk_head(src[i], bytes[i]);
      if (head) bulk_copy(dst[i], src[i], head, &bar);
    }
  }
#pragma unroll
  for (int i = 0; i < 10; ++i) {
    const unsigned char* s = static_cast<const unsigned char*>(src[i]);
    unsigned char* dd = static_cast<unsigned char*>(dst[i]);
    for (unsigned b = bulk_head(src[i], bytes[i]) + tid; b < bytes[i];
         b += NT)
      dd[b] = s[b];
  }
  mbar_wait(&bar, 0);
  __syncthreads();

  float q[4] = {a.q0[0], a.q0[1], a.q0[2], a.q0[3]};
  float t[3] = {a.t0[0], a.t0[1], a.t0[2]};
  const float a_sq = so_clamp_min(a.a_sq[0], 1e-12f);
  const float a_sq_e = edges ? so_clamp_min(a.a_sq_e[0], 1e-12f) : 1.0f;
  // the body axes at the start pose, for the edges' hold votes
  float ax0[3][3];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const float e[3] = {i == 0 ? 1.0f : 0.0f, i == 1 ? 1.0f : 0.0f,
                        i == 2 ? 1.0f : 0.0f};
    so_quat_rotate(q, e, ax0[i]);
  }
  bool hold[3] = {false, false, false};  // thread 0 of rank 0 only
  bool first_small = false;
  const int passes = a.n_iters > 0 ? a.n_iters : 1;

  for (int it = 0; it < passes; ++it) {
    float acc[GN_ACC];
#pragma unroll
    for (int v = 0; v < GN_ACC; ++v) acc[v] = 0.0f;
    for (int m = tid; m < n; m += NT) {
      const float p[3] = {sp[3 * m], sp[3 * m + 1], sp[3 * m + 2]};
      const float nn[3] = {sn[3 * m], sn[3 * m + 1], sn[3 * m + 2]};
      float wp[3];
      so_quat_rotate(q, p, wp);
      wp[0] += t[0];
      wp[1] += t[1];
      wp[2] += t[2];
      const float r = so_dot3(nn, wp) + sd[m];
      float J[6] = {nn[0], nn[1], nn[2], 0.0f, 0.0f, 0.0f};
      so_cross(wp, nn, J + 3);
      const float ratio = (r * r) / a_sq;
      const float tk = ratio < 1.0f ? (1.0f - ratio) * (1.0f - ratio) : 0.0f;
      const float w = (sv[m] ? 1.0f : 0.0f) * sc[m] * tk;
      int v = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i) {
        const float wj = w * J[i];
#pragma unroll
        for (int j = i; j < 6; ++j) acc[v++] += wj * J[j];
      }
#pragma unroll
      for (int i = 0; i < 6; ++i) acc[21 + i] += (w * J[i]) * r;
      acc[27] += (w * r) * r;
      if (it == 0 && a.hold_min > 0 && a.n_iters > 0 && sv[m]) {
        const int vote = a.obs_bins[3 * (r0 + m) + 2] - 6;
        acc[28] += vote == 0 ? 1.0f : 0.0f;
        acc[29] += vote == 1 ? 1.0f : 0.0f;
        acc[30] += vote == 2 ? 1.0f : 0.0f;
        acc[31] += 1.0f;
      }
    }
    for (int m = tid; m < ne; m += NT) {
      const float p[3] = {ep[3 * m], ep[3 * m + 1], ep[3 * m + 2]};
      const float pa[3] = {ea[3 * m], ea[3 * m + 1], ea[3 * m + 2]};
      const float pb[3] = {eb[3 * m], eb[3 * m + 1], eb[3 * m + 2]};
      float we[3];
      so_quat_rotate(q, p, we);
      we[0] += t[0];
      we[1] += t[1];
      we[2] += t[2];
      const float dab[3] = {pa[0] - pb[0], pa[1] - pb[1], pa[2] - pb[2]};
      const float dn = so_clamp_min(sqrtf(so_dot3(dab, dab)), 1e-9f);
      const float wa[3] = {we[0] - pa[0], we[1] - pa[1], we[2] - pa[2]};
      const float wb[3] = {we[0] - pb[0], we[1] - pb[1], we[2] - pb[2]};
      float r[3];
      so_cross(wa, wb, r);
      r[0] /= dn;
      r[1] /= dn;
      r[2] /= dn;
      // J_e = L [I, -skew(we)], L = skew(u), u = -d/|d|
      const float u[3] = {-dab[0] / dn, -dab[1] / dn, -dab[2] / dn};
      const float L[3][3] = {
          {0.0f, -u[2], u[1]}, {u[2], 0.0f, -u[0]}, {-u[1], u[0], 0.0f}};
      const float S[3][3] = {  // -skew(we)
          {0.0f, we[2], -we[1]}, {-we[2], 0.0f, we[0]}, {we[1], -we[0], 0.0f}};
      float J[3][6];
#pragma unroll
      for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          J[i][c] = L[i][c];
          J[i][3 + c] = L[i][0] * S[0][c] + L[i][1] * S[1][c] + L[i][2] * S[2][c];
        }
      const float sq = so_dot3(r, r);
      const float ratio = sq / a_sq_e;
      const float tk = ratio < 1.0f ? (1.0f - ratio) * (1.0f - ratio) : 0.0f;
      const float w = (ev[m] ? 1.0f : 0.0f) * ec[m] * tk;
      int v = 0;
#pragma unroll
      for (int i = 0; i < 6; ++i)
#pragma unroll
        for (int j = i; j < 6; ++j)
          acc[v++] += w * (J[0][i] * J[0][j] + J[1][i] * J[1][j] +
                           J[2][i] * J[2][j]);
#pragma unroll
      for (int i = 0; i < 6; ++i)
        acc[21 + i] += w * (J[0][i] * r[0] + J[1][i] * r[1] + J[2][i] * r[2]);
      acc[27] += w * sq;
      if (it == 0 && a.hold_min > 0 && a.n_iters > 0 && ev[m]) {
        const float dl = so_clamp_min(sqrtf(so_dot3(dab, dab)), 1e-12f);
        const float dv[3] = {dab[0] / dl, dab[1] / dl, dab[2] / dl};
#pragma unroll
        for (int i = 0; i < 3; ++i) {
          const float c = so_dot3(dv, ax0[i]);
          acc[28 + i] += 1.0f - c * c > 0.5f ? 1.0f : 0.0f;
        }
        acc[31] += 1.0f;
      }
    }
    // warp shuffles, then warps in index order: a fixed summation order
#pragma unroll
    for (int v = 0; v < GN_ACC; ++v) {
      float x = acc[v];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        x += __shfl_down_sync(0xffffffffu, x, off);
      if (lane == 0) warp_part[warp][v] = x;
    }
    __syncthreads();
    if (tid < GN_ACC) {
      float s = warp_part[0][tid];
      for (int w = 1; w < NT / 32; ++w) s += warp_part[w][tid];
      block_part[tid] = s;
    }
    cluster.sync();

    if (rank == 0) {
      if (tid < GN_ACC) {
        float s = block_part[tid];
        for (int r = 1; r < GN_BLOCKS; ++r)
          s += *cluster.map_shared_rank(block_part + tid, r);
        tot[tid] = s;
      }
      __syncthreads();
      if (tid == 0) {
        if (a.n_iters == 0) {
          int v = 0;
          for (int i = 0; i < 6; ++i)
            for (int j = i; j < 6; ++j) {
              a.out[6 * i + j] = tot[v];
              a.out[6 * j + i] = tot[v];
              ++v;
            }
          for (int i = 0; i < 7; ++i) a.out[36 + i] = tot[21 + i];
        } else {
          if (it == 0 && a.hold_min > 0) {
            const float thresh =
                fminf(fmaxf(a.hold_frac * tot[31], 1.0f), (float)a.hold_min);
            const bool armed =
                (a.hold_enabled == nullptr || a.hold_enabled[0]) &&
                (a.prior_q == nullptr || !a.prior_enabled[0]);
            for (int i = 0; i < 3; ++i) hold[i] = armed && tot[28 + i] < thresh;
          }
          const bool small = gn_update(tot, a, hold, q, t);
          if (it == 0) first_small = small;
          for (int i = 0; i < 4; ++i) pose_sh[i] = q[i];
          for (int i = 0; i < 3; ++i) pose_sh[4 + i] = t[i];
          if (it + 1 == passes) {
            for (int i = 0; i < 4; ++i) a.out[i] = q[i];
            for (int i = 0; i < 3; ++i) a.out[4 + i] = t[i];
            a.first_small[0] = first_small;
          }
        }
      }
    }
    // rank 0 is done reading the partials; its new pose is published
    cluster.sync();
    if (it + 1 < passes) {
      const float* ps = cluster.map_shared_rank(pose_sh, 0);
#pragma unroll
      for (int i = 0; i < 4; ++i) q[i] = ps[i];
#pragma unroll
      for (int i = 0; i < 3; ++i) t[i] = ps[4 + i];
    }
  }
}

// n_iters = 0 writes H[36], g[6], cost to out; otherwise q[4], t[3] to out
// and the first iteration's |delta| < 1e-6 to first_small.  ne = 0: no
// edge rows (their pointers may be null).  n_inst instances; istride
// (host) = the instance strides, in elements, of the GN_INPUTS inputs in
// the order p_body, normal, d, coeff, valid, obs_bins, q0, t0, a_sq,
// prior_q, prior_t, prior_info, prior_enabled, hold_enabled, e_p, e_a,
// e_b, e_coeff, e_valid, a_sq_e.
extern "C" int so_gn_solve(
    const float* p_body, const float* normal, const float* d,
    const float* coeff, const unsigned char* valid, const int* obs_bins,
    int nm, const float* q0, const float* t0, const float* a_sq,
    const float* prior_q, const float* prior_t, const float* prior_info,
    const unsigned char* prior_enabled, const unsigned char* hold_enabled,
    int hold_min, float hold_frac, float damping, int n_iters, float* out,
    unsigned char* first_small, const float* e_p, const float* e_a,
    const float* e_b, const float* e_coeff, const unsigned char* e_valid,
    int ne, const float* a_sq_e, int n_inst, const long long* istride,
    void* stream) {
  if (n_inst < 1 || n_inst > 65535) return (int)cudaErrorInvalidValue;
  GnArgs a;
  for (int i = 0; i < GN_INPUTS; ++i) a.is[i] = istride[i];
  a.p_body = p_body;
  a.normal = normal;
  a.d = d;
  a.coeff = coeff;
  a.valid = valid;
  a.obs_bins = obs_bins;
  a.nm = nm;
  a.rows = ((nm + GN_BLOCKS - 1) / GN_BLOCKS + 15) / 16 * 16;
  a.e_p = e_p;
  a.e_a = e_a;
  a.e_b = e_b;
  a.e_coeff = e_coeff;
  a.e_valid = e_valid;
  a.ne = ne;
  a.erows = ((ne + GN_BLOCKS - 1) / GN_BLOCKS + 15) / 16 * 16;
  a.a_sq_e = a_sq_e;
  a.q0 = q0;
  a.t0 = t0;
  a.a_sq = a_sq;
  a.prior_q = prior_q;
  a.prior_t = prior_t;
  a.prior_info = prior_info;
  a.prior_enabled = prior_enabled;
  a.hold_enabled = hold_enabled;
  a.hold_min = hold_min;
  a.hold_frac = hold_frac;
  a.damping = damping;
  a.n_iters = n_iters;
  a.out = out;
  a.first_small = first_small;
  const size_t dyn =
      (size_t)a.rows * GN_ROW_BYTES + (size_t)a.erows * GN_EDGE_ROW_BYTES;
  if (dyn > GN_MAX_DYN_SMEM) return (int)cudaErrorInvalidValue;
  if (dyn > 48 * 1024) {
    // the attribute belongs to the current device: set it on every launch
    // that needs it (it costs no launch)
    const cudaError_t e = cudaFuncSetAttribute(
        gn_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        GN_MAX_DYN_SMEM);
    if (e != cudaSuccess) return (int)e;
  }
  gn_kernel<<<dim3(GN_BLOCKS, n_inst), GN_THREADS, dyn,
              (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}
