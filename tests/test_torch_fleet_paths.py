"""The fleet's edge path and the batched launches of K10, K11a and K11b on
the CPU, at tiny sizes:

* path E (tests/test_torch_paths.py's tiny parity configuration with
  edges, fixed-count ICP) through the port's vmapped step against the JAX
  package's ``make_batched_step`` on a one-device mesh: two instances on
  two datasets, each port step from JAX's carried batched state, the ICP
  pose within 1e-4 m, both maps' keys and counts and the ICP round counts
  exact.  On the CPU that step runs the plain versions of the voxel claim,
  the curvature edges and the line fit under vmap;
* ``kernels.voxel_claim_batched``, ``curvature_edges_batched`` and
  ``edge_fit_batched`` refuse a mismatched instance count, shape or dtype
  with ValueError before they load the kernels' library.

The batched kernels themselves run on the card:
tests/test_torch_kernels_cuda.py."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
from test_torch_parallel import _dataset  # noqa: E402
from test_torch_paths import _tiny  # noqa: E402

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import parallel as jpar  # noqa: E402
from superodom_tpu.runner import OdometryRunner as JRunner  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import convert, kernels, parallel  # noqa: E402


def _path_e(mod):
    cfg = _tiny(mod, "parity")
    return dataclasses.replace(
        cfg, use_edge_features=True,
        registration=dataclasses.replace(cfg.registration,
                                         icp_early_exit=False))


def test_path_e_fleet_matches_jax():
    """Two instances of path E, 4 scans: each port step from JAX's
    carried batched state gives the ICP pose within 1e-4 m, the next
    surface and edge maps' keys and counts and the round counts exact,
    and both instances extract edges."""
    n = 4
    cfg_j, cfg_t = _path_e(jcfg), _path_e(tcfg)
    built = []
    for seed in (3, 4):
        host, _ = JRunner(cfg_j).stack_chunked_inputs(_dataset(seed, n),
                                                      chunk=n)
        built.append(host)
    # [n, B, ...] leaves: the JAX package's trees, numpy leaves
    inputs = jax.tree_util.tree_map(
        lambda *xs: np.stack([x[0] for x in xs], axis=1), *built)
    mesh = jpar.make_mesh(jax.devices()[:1], data=1, model=1)
    step_fn, shard_state = jpar.make_batched_step(cfg_j, mesh)
    state_j = shard_state(jpar.batched_init_state(cfg_j, 2))
    vstep = parallel.make_batched_step(cfg_t, device="cpu")
    counts = dict(kernels.launch_counts)
    moved, edges = 0.0, np.zeros(2, dtype=np.int64)
    for i in range(n):
        before = jax.device_get(state_j)
        inp = jax.tree_util.tree_map(lambda a: a[i], inputs)
        state_j, out_j = step_fn(state_j, *inp)
        after_j, out_j = jax.device_get((state_j, out_j))
        after_t, out_t = vstep(convert.from_numpy(before),
                               *(convert.from_numpy(x) for x in inp))
        np.testing.assert_allclose(out_t.pose.t.numpy(), out_j.pose.t,
                                   atol=1e-4)
        np.testing.assert_allclose(out_t.pose.q.numpy(), out_j.pose.q,
                                   atol=1e-4)
        for m in ("surf_map", "edge_map"):
            for f in ("keys", "cnt"):
                np.testing.assert_array_equal(
                    getattr(getattr(after_t, m), f).numpy(),
                    getattr(getattr(after_j, m), f))
        np.testing.assert_array_equal(out_t.icp.n_iterations.numpy(),
                                      out_j.icp.n_iterations)
        np.testing.assert_array_equal(out_t.edge_stack_num.numpy(),
                                      out_j.edge_stack_num)
        moved = max(moved, float(np.abs(out_j.pose.t).max()))
        edges += np.asarray(out_j.edge_stack_num)
    assert moved > 0.01  # the instances moved
    assert (edges > 0).all()  # each instance's line fit had rows
    assert kernels.launch_counts == counts  # the CPU launches no kernel


def _batched_args(name, n=2, N=64, Q=8, k=10):
    """Well-formed CPU arguments of ``kernels.<name>_batched`` for ``n``
    instances, tensors first."""
    g = torch.Generator().manual_seed(0)
    xyz = torch.randn((n, N, 3), generator=g)
    mask = torch.ones((n, N), dtype=torch.bool)
    if name == "voxel_claim":
        return [xyz, mask, torch.full((n,), 0.2)], [14]
    if name == "curvature_edges":
        return [xyz, torch.zeros((n, N), dtype=torch.int32), mask], \
            [5, 0.2, 0.5]
    return [torch.randn((n, Q, k, 3), generator=g),
            torch.rand((n, Q, k), generator=g),
            torch.ones((n, Q, k), dtype=torch.bool),
            torch.ones((n, Q), dtype=torch.bool),
            torch.full((n,), 0.1)], [4, 0.2]


@pytest.mark.parametrize("fault", ["count", "shape", "dtype"])
@pytest.mark.parametrize("name", ["voxel_claim", "curvature_edges",
                                  "edge_fit"])
def test_batched_entries_refuse_malformed_fleets(name, fault, monkeypatch):
    """Every tensor of the launch in turn: one instance too many, a
    per-instance shape one lane short, the wrong dtype, each refused for
    that fault with a ValueError before the library is loaded; the
    well-formed CPU call is refused for its device."""
    def no_load():
        raise AssertionError("the library was loaded")

    monkeypatch.setattr(kernels, "load", no_load)
    entry = getattr(kernels, f"{name}_batched")
    tensors, scalars = _batched_args(name)
    with pytest.raises(ValueError, match="expected a CUDA tensor"):
        entry(*tensors, *scalars)
    for i, t in enumerate(tensors):
        if fault == "count":
            bad = torch.cat([t, t[:1]])
            want = "instances"
        elif fault == "shape":
            bad = (t[:, :-1] if t.dim() > 1 else t[:, None]).contiguous()
            want = "shape"
        else:
            bad = t.to(torch.float64 if t.dtype != torch.float64
                       else torch.float32)
            want = "dtype"
        args = list(tensors)
        args[i] = bad
        with pytest.raises(ValueError, match=want):
            entry(*args, *scalars)
