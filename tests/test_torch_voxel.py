"""Scan thinning of the PyTorch port against the JAX package: the plain
version of the voxel_claim kernel (K10, keep-masks exact) and its dispatch,
the per-voxel centroid downsample with an extra channel (masks and lane
order exact, centroids 1e-6: ``index_add_`` and ``segment_sum`` may add in
different orders), and the table size following the sensor."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from superodom_tpu.ops import voxel as jv  # noqa: E402

from superodom_tpu_torch import kernels  # noqa: E402
from superodom_tpu_torch.ops import voxel as tv  # noqa: E402

from test_torch_frontend_inertial import T  # noqa: E402


N_CLOUD = 3000


def _cloud(seed=0, n=N_CLOUD, centre=(0.0, 0.0, 0.0)):
    """Points on and around a few surfaces, several a 0.2 m voxel, on both
    sides of every axis; every seventh lane masked out."""
    rng = np.random.default_rng(seed)
    xyz = rng.uniform(-6.0, 6.0, (n, 3)).astype(np.float32)
    xyz[: n // 2, 2] = np.float32(-1.5)  # a floor: many points a voxel
    xyz[n // 2: 3 * n // 4, 0] = np.float32(4.0)
    xyz = (xyz + np.float32(centre)).astype(np.float32)
    mask = np.arange(n) % 7 != 3
    t_rel = rng.uniform(0.0, 0.1, n).astype(np.float32)
    return xyz, mask, t_rel


SCATTER_CASES = {
    # name: (table_bits, res, centre, all lanes masked out)
    "default_table": (0, 0.2, (0.0, 0.0, 0.0), False),
    "given_table": (14, 0.2, (0.0, 0.0, 0.0), False),
    "16_entries": (4, 0.2, (0.0, 0.0, 0.0), False),  # collisions everywhere
    "negative_coordinates": (0, 0.2, (-40.0, -25.0, -9.0), False),
    "all_masked_out": (0, 0.2, (0.0, 0.0, 0.0), True),
    "coarse": (0, 0.8, (3.0, -2.0, 0.5), False),
}


@pytest.mark.parametrize("res_as_tensor", [False, True],
                         ids=["float", "tensor"])
@pytest.mark.parametrize("case", list(SCATTER_CASES))
def test_voxel_downsample_scatter_exact(case, res_as_tensor):
    bits, res, centre, dead = SCATTER_CASES[case]
    xyz, mask, _ = _cloud(1, centre=centre)
    if dead:
        mask = np.zeros_like(mask)
    keep_j = np.asarray(jv.voxel_downsample_scatter(xyz, mask,
                                                    np.float32(res), bits))
    keep_t = tv.voxel_downsample_scatter(
        T(xyz), T(mask), torch.tensor(res) if res_as_tensor else res,
        table_bits=bits)
    assert keep_t.dtype == torch.bool
    np.testing.assert_array_equal(keep_t.numpy(), keep_j)
    if dead:
        assert not keep_j.any()
    elif bits == 4:
        assert keep_j.sum() == 16  # every table entry has one survivor
    else:
        assert 100 < keep_j.sum() < mask.sum()
    if case == "negative_coordinates":
        assert (xyz < 0).all()


def test_voxel_downsample_scatter_dispatch():
    xyz, mask, _ = _cloud(2)
    a = tv.voxel_downsample_scatter(T(xyz), T(mask), 0.2)
    b = tv.voxel_downsample_scatter_reference(T(xyz), T(mask), 0.2)
    assert torch.equal(a, b)
    with pytest.raises(ValueError):  # the kernel's wrapper: CUDA tensors only
        kernels.voxel_claim(T(xyz), T(mask), torch.tensor(0.2), 14)


@pytest.mark.parametrize("res", [0.2, 0.7])
def test_voxel_downsample_centroid_with_extras(res):
    xyz, mask, t_rel = _cloud(3)
    two = np.stack([t_rel, 1.0 - t_rel], axis=1).astype(np.float32)
    out_j = jv.voxel_downsample_centroid(xyz, mask, np.float32(res), t_rel,
                                         two)
    out_t = tv.voxel_downsample_centroid(T(xyz), T(mask), torch.tensor(res),
                                         T(t_rel), T(two))
    assert len(out_t) == 4
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    for a, b in zip((out_t[0], *out_t[2:]), (out_j[0], *out_j[2:])):
        assert a.shape == np.asarray(b).shape
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                   atol=1e-6)
    n_vox = int(np.asarray(out_j[1]).sum())
    assert 50 < n_vox < mask.sum()
    assert not out_t[0].numpy()[n_vox:].any()  # compacted to the front


def test_thin_and_select_table_bits_follows_the_sensor():
    """The table size decides which voxels merge: the default (4x the lane
    count) and a wider sensor's table keep different lanes, and both sides
    agree on each."""
    xyz, mask, _ = _cloud(5)
    keeps = []
    for bits in (0, 11):
        kj = np.asarray(jv.voxel_downsample_scatter(xyz, mask,
                                                    np.float32(0.2), bits))
        kt = tv.voxel_downsample_scatter(T(xyz), T(mask), 0.2, bits).numpy()
        np.testing.assert_array_equal(kt, kj)
        keeps.append(kj)
    assert (keeps[0] != keeps[1]).any()
