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
// never multiplied by a zero weight.  Every sum runs in index order in one
// thread, so with --fmad=false the outputs are the plain version's to the
// bit.
//
// What bounds it on an H100: at the main path's 512 features x k = 10 it
// is one short launch (~25 KB in, ~20 KB out; ~1,500 flops a feature: the
// 81 cross products of the consensus, the PCA, the eigensolver).  Design:
// one thread a correspondence, k a template parameter (10, the presets';
// any other k <= 16 takes the runtime-k instance), the row, the distances
// and the 9 line directions in registers, the consensus as one bit mask a
// candidate line (no runtime indexing), every load at the top; the
// eigensolver is K3's (csrc/eigh3.cuh).
//
// Instances: one launch serves n_inst independent sets of nq
// correspondences (the batched step of superodom_tpu_torch/parallel.py),
// flattened: thread g of n_inst * nq is correspondence g % nq of instance
// g / nq.  An instance's neighbourhoods, distances, validity, mask and
// line resolution start istride[0..4] elements after instance 0's (0:
// shared), its outputs at i * nq.  Each instance computes exactly what a
// launch on its own inputs computes, and n_inst = 1 is the single launch.
#include <math.h>

#include "common.cuh"
#include "eigh3.cuh"

#define EF_MAX_K 16
#define EF_BLOCK 64  // correspondences (= threads) a block

// the instance strides of neigh, sq, nvalid, mask and line_res, in elements
struct EfStrides {
  long long s[5];
};

template <int K>
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
  const int k = K > 0 ? K : k_rt;
  const long long g = (long long)blockIdx.x * EF_BLOCK + threadIdx.x;
  if (g >= n_all) return;
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

  float P[KM][3], sqv[KM];
  bool nv[KM];
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
#pragma unroll
      for (int a = 0; a < 3; ++a) P[j][a] = neigh[((size_t)m * k + j) * 3 + a];
      sqv[j] = sq[(size_t)m * k + j];
      nv[j] = nvalid[(size_t)m * k + j] != 0;
    }
  }
  const bool mk = mask[m] != 0;
  const float line_res = line_res_p[0];

  // ---- consensus: the best line through the nearest point
  float rel[KM][3], dir[KM][3];  // lanes 1..k-1 at 0..k-2
#pragma unroll
  for (int r = 0; r + 1 < KM; ++r) {
    if (r + 1 < k) {
#pragma unroll
      for (int a = 0; a < 3; ++a) rel[r][a] = P[r + 1][a] - P[0][a];
      const float nr = so_clamp_min(sqrtf(so_dot3(rel[r], rel[r])), 1e-12f);
#pragma unroll
      for (int a = 0; a < 3; ++a) dir[r][a] = rel[r][a] / nr;
    }
  }
  unsigned best_bits = 0u;
  int best_cnt = -1;
#pragma unroll
  for (int j = 0; j + 1 < KM; ++j) {
    if (j + 1 < k) {
      unsigned bits = 0u;
      int cnt = 0;
#pragma unroll
      for (int c = 0; c + 1 < KM; ++c) {
        if (c + 1 < k) {
          float cr[3];
          so_cross(rel[c], dir[j], cr);
          const bool in = (so_dot3(cr, cr) < inlier_sq || c == j) &&
                          nv[c + 1] && nv[j + 1];
          bits |= (in ? 1u : 0u) << c;
          cnt += in ? 1 : 0;
        }
      }
      if (cnt > best_cnt) {  // strict: the first maximum wins
        best_cnt = cnt;
        best_bits = bits;
      }
    }
  }
  float w[KM];
  int n_sel = 0;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
      const bool s = j == 0 ? nv[0] : ((best_bits >> (j - 1)) & 1u) != 0u;
      w[j] = s ? 1.0f : 0.0f;
      n_sel += s ? 1 : 0;
    }
  }
  const bool enough = n_sel >= min_nb;
  const float max_sq = 3.0f * line_res;
  // the farthest selected neighbour: -inf for none, a NaN propagates
  float far_sq = -INFINITY;
  bool far_nan = false;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k && w[j] != 0.0f) {
      far_nan = far_nan || isnan(sqv[j]);
      far_sq = sqv[j] > far_sq ? sqv[j] : far_sq;
    }
  }
  const bool far_ok = !far_nan && far_sq <= max_sq;

  // ---- weighted mean + unnormalised scatter of the selected set (K3's)
  float wsum = 0.0f;
#pragma unroll
  for (int j = 0; j < KM; ++j)
    if (j < k) wsum += w[j];
  wsum = fmaxf(wsum, 1e-6f);
  float mean[3];
#pragma unroll
  for (int a = 0; a < 3; ++a) {
    float s = 0.0f;
#pragma unroll
    for (int j = 0; j < KM; ++j)
      if (j < k) s += P[j][a] * w[j];
    mean[a] = s / wsum;
  }
  float cov[3][3] = {{0.0f}};
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
      float c[3];
#pragma unroll
      for (int a = 0; a < 3; ++a) c[a] = (P[j][a] - mean[a]) * w[j];
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

  // ---- residual gate: squared distance of each selected point to the line
  bool mse_ok = true;
  float perp_sum = 0.0f;
#pragma unroll
  for (int j = 0; j < KM; ++j) {
    if (j < k) {
      const float r[3] = {P[j][0] - mean[0], P[j][1] - mean[1],
                          P[j][2] - mean[2]};
      const float along = so_dot3(r, ld);
      const float perp = so_dot3(r, r) - along * along;
      const bool s = w[j] != 0.0f;
      if (s) mse_ok = mse_ok && perp <= max_sq;
      perp_sum = perp_sum + (s ? perp : 0.0f);
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

#pragma unroll
  for (int a = 0; a < 3; ++a) {
    a_out[(size_t)m * 3 + a] = mean[a] + 0.1f * ld[a];
    b_out[(size_t)m * 3 + a] = mean[a] - 0.1f * ld[a];
  }
  coeff_out[m] = valid ? coeff : 0.0f;
  valid_out[m] = valid;
  code_out[m] = code;
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
  const unsigned blocks = (unsigned)((n_all + EF_BLOCK - 1) / EF_BLOCK);
  edge_fit_kernel<K><<<blocks, EF_BLOCK, 0, stream>>>(
      neigh, sq, nvalid, mask, line_res, nq, n_all, k, min_nb, inlier_sq, a,
      b, coeff, valid, code, is);
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
      (long long)n_inst * nq > (long long)EF_BLOCK * 0x7fffffff)
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
