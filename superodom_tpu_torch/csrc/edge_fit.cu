// K11b edge_fit — line-inlier consensus, PCA line fit, gates and rejection
// code of every point-to-line correspondence.
//
// Replaces: superodom_tpu/registration.py _edge_fit (:367-447) +
// _weighted_pca (:145-154) and superodom_tpu/ops/eigh3.py eigh3 (:21-110).
// Plain version: registration.edge_fit_reference.
//
// Per correspondence, over its k selected neighbours (p1 = the nearest):
//   * consensus: for each candidate line j through p1 and neighbour j+1,
//     every neighbour c+1 is an inlier when |(p_{c+1} - p1) x dir_j|^2 <
//     edge_max_dist_inlier^2 (strict), or c == j, and both lanes are
//     valid; the line with the most inliers wins, the FIRST on a tie; the
//     selected set is p1 (if valid) and the winner's inliers;
//   * gates, in the reference's order: enough selected (>=
//     min_edge_neighbors); the farthest selected squared distance <=
//     3*line_res (-inf for an empty set, so it passes; NaN fails);
//     lambda_max >= min_edge_neighbors * lambda_mid of the selected
//     scatter; every selected point within 3*line_res (squared
//     perpendicular distance) of the line;
//   * the line's endpoints mean +- 0.1 * (largest eigenvector), the fit
//     coefficient, validity and the rejection code.
// Invalid neighbour lanes hold the BIG sentinel or a point of table row 0:
// their perpendicular distances (inf - inf = NaN) are dropped by selects,
// never multiplied by a zero weight.  Every sum runs in index order, so
// with --fmad=false the outputs are the plain version's to the bit.
//
// What bounds it on an H100: at the main path's 512 features x k = 10 it
// is one short launch (~25 KB in, ~20 KB out; ~1,500 flops a feature: the
// 81 cross products of the consensus, the PCA, the eigensolver), so its
// time is the launch and the longest chain of dependent steps in one
// correspondence; a fleet's launch (up to 64 x 512 features) runs out of
// issue slots instead.
//
// Design: a group of G lanes a correspondence (G = 16: two a warp).  Every
// lane reads the whole row (the group's lanes read the same addresses: one
// broadcast load each); lane l owns candidate lines l, l+G, ... (through
// p1 and neighbour j+1) and neighbours l, l+G, ...:
//   * it normalises its own lines only (one root and three divisions each)
//     and tests every neighbour against them (k-1 cross products a line),
//     giving each line's inlier bits and count, each float op the one a
//     single thread made on the same operands;
//   * the winner is one warp maximum over the group of the key (count <<
//     4) | (15 - j): the first line of the largest count, as the strict
//     > of a serial scan and torch.argmax choose;
//   * the weights, the weighted mean and scatter (summed in index order)
//     and K3's eigensolver (csrc/eigh3.cuh) run on every lane of the
//     group alike, so each lane holds the bits a single thread would, and
//     neither the mean nor the direction needs a shuffle;
//   * lane l takes its neighbours' perpendicular distances; the far
//     gate's maximum is a group maximum (its order cannot change a
//     maximum), its NaN flag and the residual gate are ballots, the
//     residual sum is taken in index order from shuffles;
//   * the group's lanes write a, b, coeff, valid and code together.
// The serial part (mean, scatter, eigensolver) costs every lane of the
// group, so G follows the launch: 16 up to EF_GROUP_MAX = 6,144
// correspondences (path E's 512, a fleet of up to 12), where the chain's
// length decides; 1 beyond (a fleet of 64 x 512: the issue slots decide,
// and one thread a correspondence is the cheapest).  The threshold is
// where the two measured equal on an H100 (a fleet of 12 x 512).  k is a
// template parameter (10, the presets'; any other k <= 16 takes the
// runtime-k instance).
//
// Instances: one launch serves n_inst independent sets of nq
// correspondences (the batched step of superodom_tpu_torch/parallel.py),
// flattened: group g of n_inst * nq is correspondence g % nq of instance
// g / nq.  An instance's neighbourhoods, distances, validity, mask and
// line resolution start istride[0..4] elements after instance 0's (0:
// shared), its outputs at i * nq.  Each instance computes exactly what a
// launch on its own inputs computes, and n_inst = 1 is the single launch.
#include <math.h>

#include "common.cuh"
#include "eigh3.cuh"

#define EF_MAX_K 16
#define EF_BLOCK 128  // threads a block
// lanes a correspondence: 16 up to EF_GROUP_MAX correspondences a launch,
// else 1
#define EF_GROUP_MAX 6144

// the instance strides of neigh, sq, nvalid, mask and line_res, in elements
struct EfStrides {
  long long s[5];
};

// v[i] for a lane-dependent i in 0..2, without indexing registers
static __device__ __forceinline__ float so_pick3(const float v[3], int i) {
  return i == 0 ? v[0] : i == 1 ? v[1] : v[2];
}

// K: k when compiled (0: k_rt).  G: lanes a correspondence (16 or 1);
// lane l of a group owns lines l, l+G, ... and neighbours l, l+G, ...
template <int K, int G>
__global__ void __launch_bounds__(EF_BLOCK) edge_fit_kernel(
    const float* __restrict__ neigh, const float* __restrict__ sq,
    const unsigned char* __restrict__ nvalid,
    const unsigned char* __restrict__ mask,
    const float* __restrict__ line_res_p, int nq, long long n_all, int k_rt,
    int min_nb, float inlier_sq, float* __restrict__ a_out,
    float* __restrict__ b_out, float* __restrict__ coeff_out,
    unsigned char* __restrict__ valid_out, int* __restrict__ code_out,
    EfStrides is) {
  constexpr int KM = K > 0 ? K : EF_MAX_K;
  constexpr int LINES = (KM - 1 + G - 1) / G;  // lines a lane, at most
  constexpr int OWN = (KM + G - 1) / G;        // neighbours a lane, at most
  const int k = K > 0 ? K : k_rt;
  const int lane32 = threadIdx.x & 31;
  const int l = lane32 & (G - 1);
  const long long g = ((long long)blockIdx.x * EF_BLOCK + threadIdx.x) / G;
  if (g >= n_all) return;  // uniform per group
  const unsigned gmask = ((1u << G) - 1u) << (lane32 & (32 - G));
  const long long inst = g / nq;
  const int m = (int)(g - inst * nq);
  neigh += inst * is.s[0];
  sq += inst * is.s[1];
  nvalid += inst * is.s[2];
  mask += inst * is.s[3];
  line_res_p += inst * is.s[4];
  a_out += 3 * inst * nq;
  b_out += 3 * inst * nq;
  coeff_out += inst * nq;
  valid_out += inst * nq;
  code_out += inst * nq;

  // the row (every lane alike: the group's lanes read the same addresses),
  // the validity as bits, and this lane's own neighbours' distances
  const size_t row = (size_t)m * k;
  float P[KM][3];
  unsigned nvm = 0u;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i < k) {
#pragma unroll
      for (int a = 0; a < 3; ++a) P[i][a] = neigh[(row + i) * 3 + a];
      nvm |= (nvalid[row + i] != 0 ? 1u : 0u) << i;
    }
  }
  float sq_own[OWN];
#pragma unroll
  for (int t = 0; t < OWN; ++t) {
    const int j = l + t * G;
    sq_own[t] = j < k ? sq[row + j] : 0.0f;
  }
  const bool mk = mask[m] != 0;
  const float line_res = line_res_p[0];

  // ---- consensus: this lane's lines through the nearest point, then the
  // group's keyed maximum (count << 4) | (15 - j): the first line of the
  // largest count
  unsigned key = 0u, key_bits = 0u;
#pragma unroll
  for (int t = 0; t < LINES; ++t) {
    const int j = l + t * G;
    if (j + 1 < k) {
      float dir[3];
      {
        float rel[3];
#pragma unroll
        for (int a = 0; a < 3; ++a)
          rel[a] = neigh[(row + j + 1) * 3 + a] - P[0][a];
        const float nr = so_clamp_min(sqrtf(so_dot3(rel, rel)), 1e-12f);
#pragma unroll
        for (int a = 0; a < 3; ++a) dir[a] = rel[a] / nr;
      }
      const bool nv_line = ((nvm >> (j + 1)) & 1u) != 0u;
      unsigned bits = 0u;
      int cnt = 0;
#pragma unroll
      for (int c = 0; c + 1 < KM; ++c) {
        if (c + 1 < k) {
          float rel[3], cr[3];
#pragma unroll
          for (int a = 0; a < 3; ++a) rel[a] = P[c + 1][a] - P[0][a];
          so_cross(rel, dir, cr);
          const bool in = (so_dot3(cr, cr) < inlier_sq || c == j) &&
                          ((nvm >> (c + 1)) & 1u) != 0u && nv_line;
          bits |= (in ? 1u : 0u) << c;
          cnt += in ? 1 : 0;
        }
      }
      const unsigned kj = ((unsigned)cnt << 4) | (unsigned)(15 - j);
      if (kj > key) {
        key = kj;
        key_bits = bits;
      }
    }
  }
  unsigned best_bits = key_bits;
  if (G > 1) {
    const unsigned best = __reduce_max_sync(gmask, key);
    best_bits =
        __shfl_sync(gmask, key_bits, (15 - (int)(best & 15u)) & (G - 1), G);
  }

  float w[KM];
  int n_sel = 0;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i < k) {
      const bool s = i == 0 ? (nvm & 1u) != 0u
                            : ((best_bits >> (i - 1)) & 1u) != 0u;
      w[i] = s ? 1.0f : 0.0f;
      n_sel += s ? 1 : 0;
    }
  }
  bool s_own[OWN];
#pragma unroll
  for (int t = 0; t < OWN; ++t) {
    const int j = l + t * G;
    s_own[t] = j < k && (j == 0 ? (nvm & 1u) != 0u
                                : ((best_bits >> (j - 1)) & 1u) != 0u);
  }
  const bool enough = n_sel >= min_nb;
  const float max_sq = 3.0f * line_res;
  // the farthest selected neighbour: -inf for none, a NaN fails the gate
  float far_sq = -INFINITY;
  bool far_nan = false;
#pragma unroll
  for (int t = 0; t < OWN; ++t) {
    if (s_own[t]) {
      far_nan = far_nan || isnan(sq_own[t]);
      far_sq = sq_own[t] > far_sq ? sq_own[t] : far_sq;
    }
  }
  if (G > 1) {
#pragma unroll
    for (int o = G / 2; o > 0; o >>= 1)
      far_sq = fmaxf(far_sq, __shfl_xor_sync(gmask, far_sq, o, G));
    far_nan = (__ballot_sync(gmask, far_nan) & gmask) != 0u;
  }
  const bool far_ok = !far_nan && far_sq <= max_sq;

  // ---- weighted mean + unnormalised scatter of the selected set (K3's),
  // the same on every lane of the group
  float wsum = 0.0f;
#pragma unroll
  for (int i = 0; i < KM; ++i)
    if (i < k) wsum += w[i];
  wsum = fmaxf(wsum, 1e-6f);
  float mean[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float s = 0.0f;
#pragma unroll
    for (int i = 0; i < KM; ++i)
      if (i < k) s += P[i][a] * w[i];
    mean[a] = s / wsum;
  }
  float cov[3][3] = {{0.0f}};
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i < k) {
      float c[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = (P[i][a] - mean[a]) * w[i];
#pragma unroll
      for (int a = 0; a < 3; ++a)
#pragma unroll
        for (int b = 0; b < 3; ++b) cov[a][b] += c[a] * c[b];
    }
  }
  float ev[3], v_lo[3], ld[3];
  so_eigvals3(cov, ev);
  so_eigvec(cov, ev[0], v_lo);
  so_eigvec_hi(cov, ev[2], v_lo, ld);
  const bool pca_ok = ev[2] >= (float)min_nb * ev[1];

  // ---- residual gate: this lane's neighbours' squared distances to the
  // line; their sum in index order from the group's lanes
  float term[OWN];
  bool mse_bad = false;
#pragma unroll
  for (int t = 0; t < OWN; ++t) {
    const int j = l + t * G;
    float r[3];
#pragma unroll
    for (int a = 0; a < 3; ++a)
      r[a] = (j < k ? neigh[(row + j) * 3 + a] : 0.0f) - mean[a];
    const float along = so_dot3(r, ld);
    const float perp = so_dot3(r, r) - along * along;
    mse_bad = mse_bad || (s_own[t] && !(perp <= max_sq));
    term[t] = s_own[t] ? perp : 0.0f;
  }
  if (G > 1) mse_bad = (__ballot_sync(gmask, mse_bad) & gmask) != 0u;
  const bool mse_ok = !mse_bad;
  float perp_sum = 0.0f;
#pragma unroll
  for (int i = 0; i < KM; ++i) {
    if (i < k) {
      const float v = term[i / G];
      perp_sum = perp_sum + (G > 1 ? __shfl_sync(gmask, v, i % G, G) : v);
    }
  }
  const float mean_sq = perp_sum / fmaxf((float)n_sel, 1.0f);
  float ratio = so_clamp_min(mean_sq / max_sq, 0.0f);  // torch.clamp: NaN stays
  ratio = ratio > 1.0f ? 1.0f : ratio;
  const float coeff = 1.0f - sqrtf(ratio);
  const bool valid = mk && enough && far_ok && pca_ok && mse_ok;

  int code = 0;
  if (!mse_ok) code = 5;
  if (!pca_ok) code = 3;
  if (!far_ok) code = 2;
  if (!enough) code = 1;
  if (!mk) code = 6;

  // the nine outputs: a, b, coeff, valid, code, item l + t*G on lane l
#pragma unroll
  for (int t = 0; t * G < 9; ++t) {
    const int it = l + t * G;
    if (it < 3) {
      a_out[(size_t)m * 3 + it] = so_pick3(mean, it) + 0.1f * so_pick3(ld, it);
    } else if (it < 6) {
      b_out[(size_t)m * 3 + it - 3] =
          so_pick3(mean, it - 3) - 0.1f * so_pick3(ld, it - 3);
    } else if (it == 6) {
      coeff_out[m] = valid ? coeff : 0.0f;
    } else if (it == 7) {
      valid_out[m] = valid;
    } else if (it == 8) {
      code_out[m] = code;
    }
  }
}

template <int K, int G>
static void so_launch_edge_fit_g(const float* neigh, const float* sq,
                                 const unsigned char* nvalid,
                                 const unsigned char* mask,
                                 const float* line_res, int nq,
                                 long long n_all, int k, int min_nb,
                                 float inlier_sq, float* a, float* b,
                                 float* coeff, unsigned char* valid,
                                 int* code, const EfStrides& is,
                                 cudaStream_t stream) {
  constexpr long long per_block = EF_BLOCK / G;
  const unsigned blocks = (unsigned)((n_all + per_block - 1) / per_block);
  edge_fit_kernel<K, G><<<blocks, EF_BLOCK, 0, stream>>>(
      neigh, sq, nvalid, mask, line_res, nq, n_all, k, min_nb, inlier_sq, a,
      b, coeff, valid, code, is);
}

template <int K>
static void so_launch_edge_fit(const float* neigh, const float* sq,
                               const unsigned char* nvalid,
                               const unsigned char* mask,
                               const float* line_res, int nq, int n_inst,
                               int k, int min_nb, float inlier_sq, float* a,
                               float* b, float* coeff, unsigned char* valid,
                               int* code, const EfStrides& is,
                               cudaStream_t stream) {
  const long long n_all = (long long)n_inst * nq;
#define EF_ARGS                                                             \
  neigh, sq, nvalid, mask, line_res, nq, n_all, k, min_nb, inlier_sq, a, b, \
      coeff, valid, code, is, stream
  if (n_all <= EF_GROUP_MAX)
    so_launch_edge_fit_g<K, 16>(EF_ARGS);
  else
    so_launch_edge_fit_g<K, 1>(EF_ARGS);
#undef EF_ARGS
}

// inlier_sq = edge_max_dist_inlier^2, rounded to float as the plain
// version's Python scalar is.  istride (host) = the instance strides, in
// elements, of neigh, sq, nvalid, mask and line_res.
extern "C" int so_edge_fit(const float* neigh, const float* sq,
                           const unsigned char* nvalid,
                           const unsigned char* mask, const float* line_res,
                           int nq, int k, int min_nb, float inlier_sq,
                           float* a, float* b, float* coeff,
                           unsigned char* valid, int* code, int n_inst,
                           const long long* istride, void* stream) {
  if (k < 2 || k > EF_MAX_K || nq < 0 || n_inst < 1 ||
      (long long)n_inst * nq > (long long)EF_BLOCK * 0x7fffffff / 16)
    return (int)cudaErrorInvalidValue;
  EfStrides is;
  for (int i = 0; i < 5; ++i) is.s[i] = istride[i];
  if (nq > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    if (k == 10)
      so_launch_edge_fit<10>(neigh, sq, nvalid, mask, line_res, nq, n_inst, k,
                             min_nb, inlier_sq, a, b, coeff, valid, code, is,
                             s);
    else
      so_launch_edge_fit<0>(neigh, sq, nvalid, mask, line_res, nq, n_inst, k,
                            min_nb, inlier_sq, a, b, coeff, valid, code, is,
                            s);
  }
  return (int)cudaGetLastError();
}
