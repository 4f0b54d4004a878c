"""The counted kernel entries as PyTorch custom operators, so that
``torch.func.vmap`` carries the batched step (``parallel.py``) through
them.

A ctypes launch takes device pointers, which a tensor under vmap does not
have.  Each entry of ``kernels.KERNELS`` is therefore registered here as a
``torch.library.custom_op`` ("superodom::<name>").  Called on plain CUDA
tensors it is the single launch of ``kernels``.  Under vmap its rule
(``register_vmap``) moves each batched argument's vmapped dimension to the
front and makes it contiguous, expands each unbatched one to the batch (a
stride of 0: one copy shared by every instance), and serves every instance
with what the rule's route gives:

* instance dimension (one launch): K1 octant_lookup, K2 knn_select, K9a
  reduce_candidates, K3 plane_fit, K4 gn_solve and normal_system, K10
  voxel_claim (one claim table an instance), K11a curvature_edges (the
  stencil wrapping within each instance) (``kernels.*_batched``, the
  instance on ``blockIdx.y``), and K11b edge_fit
  (``kernels.edge_fit_batched``, one thread a correspondence of the B x Q,
  each reading its instance's line resolution);
* flattened (one launch): K9b select_reduced, whose every input is per
  query, over the B x Q queries.

A rule never hands work to a plain version, and a kernel reached under
vmap without a rule raises (``kernels._check``).  The dispatching wrappers
(``mapstate``, ``registration``, ``frontend``, ``ops.voxel``) call these
operators for CUDA tensors and the plain versions for CPU tensors; under
vmap on the CPU the plain versions batch by themselves.

The schemas take tensors, ints and floats only: an optional group of
tensors (K4's prior and edge rows) is flattened into optional tensors.
"""

from typing import Optional, Tuple

import torch
from torch import Tensor

from superodom_tpu_torch import kernels

_T2 = Tuple[Tensor, Tensor]
_T3 = Tuple[Tensor, Tensor, Tensor]
_T4 = Tuple[Tensor, Tensor, Tensor, Tensor]
_T5 = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor]
_T6 = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]
_T7 = Tuple[Tensor, Tensor, Tensor, Tensor, Tensor, Tensor, Tensor]

# the route of each entry under vmap (chip_smoke.py reports it)
ROUTE = {
    "octant_lookup": "instance dimension",
    "knn_select": "instance dimension",
    "reduce_candidates": "instance dimension",
    "plane_fit": "instance dimension",
    "gn_solve": "instance dimension",
    "normal_system": "instance dimension",
    "select_reduced": "flattened",
    "voxel_claim": "instance dimension",
    "curvature_edges": "instance dimension",
    "edge_fit": "instance dimension",
}


def _op(name: str):
    return torch.library.custom_op(f"superodom::{name}", mutates_args=())


def _front(x: Optional[Tensor], dim: Optional[int], n: int):
    """A rule's argument with its ``n`` instances first: the vmapped
    dimension moved to the front, or an unbatched tensor expanded to ``n``
    without a copy.  None stays None."""
    if x is None:
        return None
    if dim is None:
        return x.contiguous().expand((n,) + tuple(x.shape))
    return x.movedim(dim, 0).contiguous()


def _fronts(info, in_dims, *args):
    return [_front(a, d, info.batch_size) if isinstance(a, Tensor) else a
            for a, d in zip(args, in_dims)]


def _group(*xs):
    """An optional group of tensors: None where its first is None."""
    return None if xs[0] is None else tuple(xs)


# ---------------------------------------------------------- K1, K2, K9a


@_op("octant_lookup")
def octant_lookup(keys: Tensor, queries: Tensor, cell_size: float,
                  bucket_lo: int = 0, nb_total: int = 0) -> Tensor:
    return kernels.octant_lookup(keys, queries, cell_size, bucket_lo,
                                 nb_total)


@octant_lookup.register_vmap
def _(info, in_dims, keys, queries, cell_size, bucket_lo=0, nb_total=0):
    return kernels.octant_lookup_batched(
        *_fronts(info, in_dims, keys, queries), cell_size, bucket_lo,
        nb_total), 0


@_op("knn_select")
def knn_select(pts: Tensor, slots: Tensor, queries: Tensor, k: int) -> _T4:
    return kernels.knn_select(pts, slots, queries, k)


@knn_select.register_vmap
def _(info, in_dims, pts, slots, queries, k):
    return kernels.knn_select_batched(
        *_fronts(info, in_dims, pts, slots, queries), k), (0,) * 4


@_op("reduce_candidates")
def reduce_candidates(pts: Tensor, slots: Tensor, queries: Tensor, w: int,
                      k: int) -> _T7:
    """(x, y, z, valid) [Q, w], then (neighbours [Q, k, 3], sq, valid)."""
    return kernels.reduce_candidates(pts, slots, queries, w, k)


@reduce_candidates.register_vmap
def _(info, in_dims, pts, slots, queries, w, k):
    return kernels.reduce_candidates_batched(
        *_fronts(info, in_dims, pts, slots, queries), w, k), (0,) * 7


# ------------------------------------------------------------------ K9b


@_op("select_reduced")
def select_reduced(x: Tensor, y: Tensor, z: Tensor, valid: Tensor,
                   queries: Tensor, k: int) -> _T3:
    return kernels.select_reduced(x, y, z, valid, queries, k)


@select_reduced.register_vmap
def _(info, in_dims, x, y, z, valid, queries, k):
    n = info.batch_size
    args = _fronts(info, in_dims, x, y, z, valid, queries)
    nq = args[-1].shape[1]
    outs = kernels.select_reduced(
        *(a.reshape((n * nq,) + a.shape[2:]) for a in args), k)
    return tuple(o.reshape((n, nq) + o.shape[1:]) for o in outs), (0,) * 3


# ------------------------------------------------------------------- K3


@_op("plane_fit")
def plane_fit(neigh: Tensor, sq: Tensor, nvalid: Tensor, mask: Tensor,
              w_pt: Tensor, q: Tensor, plane_res: Tensor) -> _T6:
    return kernels.plane_fit(neigh, sq, nvalid, mask, w_pt, q, plane_res)


@plane_fit.register_vmap
def _(info, in_dims, *args):
    return kernels.plane_fit_batched(*_fronts(info, in_dims, *args)), \
        (0,) * 6


# ------------------------------------------------------------------- K4


@_op("normal_system")
def normal_system(p_body: Tensor, normal: Tensor, d: Tensor, coeff: Tensor,
                  valid: Tensor, q: Tensor, t: Tensor, a_sq: Tensor,
                  e_p: Optional[Tensor], e_a: Optional[Tensor],
                  e_b: Optional[Tensor], e_coeff: Optional[Tensor],
                  e_valid: Optional[Tensor],
                  a_sq_e: Optional[Tensor]) -> Tensor:
    """f32[43]: H (36, row-major), g (6), cost."""
    return kernels.normal_system(p_body, normal, d, coeff, valid, q, t, a_sq,
                                 _group(e_p, e_a, e_b, e_coeff, e_valid),
                                 a_sq_e)


@normal_system.register_vmap
def _(info, in_dims, *args):
    a = _fronts(info, in_dims, *args)
    return kernels.normal_system_batched(*a[:8], _group(*a[8:13]),
                                         a[13]), 0


@_op("gn_solve")
def gn_solve(p_body: Tensor, normal: Tensor, d: Tensor, coeff: Tensor,
             valid: Tensor, obs_bins: Tensor, q: Tensor, t: Tensor,
             a_sq: Tensor, n_iters: int, damping: float,
             prior_q: Optional[Tensor], prior_t: Optional[Tensor],
             prior_info: Optional[Tensor], prior_enabled: Optional[Tensor],
             hold_min: int, hold_frac: float, hold_enabled: Optional[Tensor],
             e_p: Optional[Tensor], e_a: Optional[Tensor],
             e_b: Optional[Tensor], e_coeff: Optional[Tensor],
             e_valid: Optional[Tensor], a_sq_e: Optional[Tensor]) -> _T2:
    """(f32[7]: q and t, first_small bool[])."""
    return kernels.gn_solve(
        p_body, normal, d, coeff, valid, obs_bins, q, t, a_sq, n_iters,
        damping, _group(prior_q, prior_t, prior_info, prior_enabled),
        hold_min, hold_frac, hold_enabled,
        _group(e_p, e_a, e_b, e_coeff, e_valid), a_sq_e)


@gn_solve.register_vmap
def _(info, in_dims, *args):
    a = _fronts(info, in_dims, *args)
    return kernels.gn_solve_batched(
        *a[:9], a[9], a[10], _group(*a[11:15]), a[15], a[16], a[17],
        _group(*a[18:23]), a[23]), (0, 0)


# ------------------------------------------------------ K10, K11a, K11b


@_op("voxel_claim")
def voxel_claim(xyz: Tensor, mask: Tensor, res: Tensor,
                table_bits: int) -> Tensor:
    return kernels.voxel_claim(xyz, mask, res, table_bits)


@voxel_claim.register_vmap
def _(info, in_dims, xyz, mask, res, table_bits):
    return kernels.voxel_claim_batched(
        *_fronts(info, in_dims, xyz, mask, res), table_bits), 0


@_op("curvature_edges")
def curvature_edges(xyz: Tensor, ring: Tensor, mask: Tensor,
                    half_window: int, threshold: float,
                    min_range: float) -> Tensor:
    return kernels.curvature_edges(xyz, ring, mask, half_window, threshold,
                                   min_range)


@curvature_edges.register_vmap
def _(info, in_dims, xyz, ring, mask, half_window, threshold, min_range):
    return kernels.curvature_edges_batched(
        *_fronts(info, in_dims, xyz, ring, mask), half_window, threshold,
        min_range), 0


@_op("edge_fit")
def edge_fit(neigh: Tensor, sq: Tensor, nvalid: Tensor, mask: Tensor,
             line_res: Tensor, min_neighbors: int,
             max_dist_inlier: float) -> _T5:
    return kernels.edge_fit(neigh, sq, nvalid, mask, line_res, min_neighbors,
                            max_dist_inlier)


@edge_fit.register_vmap
def _(info, in_dims, neigh, sq, nvalid, mask, line_res, min_neighbors,
      max_dist_inlier):
    return kernels.edge_fit_batched(
        *_fronts(info, in_dims, neigh, sq, nvalid, mask, line_res),
        min_neighbors, max_dist_inlier), (0,) * 5
