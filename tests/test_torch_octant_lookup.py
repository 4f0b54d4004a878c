"""The plain version of the octant_lookup kernel (K1) of the PyTorch port
against the JAX package's gather_candidates, slot for slot: the bucket sizes
beside the presets' 128, a key held twice in one bucket row, queries on cell
boundaries, and cells below zero and across the wrap of the key fields."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu.config import MapConfig as JMapConfig  # noqa: E402

from superodom_tpu_torch import convert, mapstate as tm  # noqa: E402

from test_torch_mapstate import T  # noqa: E402


def _slot_map(cells, nb, B):
    """A JAX-package map in numpy that holds ``cells`` (int [N, 3]), each in
    the first free lane of its bucket row, with one point a slot whose x
    is the slot's index: the candidates the JAX package gathers then name
    the slots it looked up."""
    packed = np.asarray(jm.pack_cells(np.asarray(cells, np.int32)))
    bucket = np.asarray(jm._bucket_of(packed, nb))
    keys = np.full((nb, B), -1, np.int32)
    fill = np.zeros(nb, np.int64)
    for p, b in zip(packed.tolist(), bucket.tolist()):
        if fill[b] < B and p not in keys[b, :fill[b]]:
            keys[b, fill[b]] = p
            fill[b] += 1
    pts = np.zeros((nb * B, 3), np.float32)
    pts[:, 0] = np.arange(nb * B)
    return jm.VoxelHashMap(keys=keys, pts=pts, cnt=(keys >= 0).astype(np.int32))


def _slots_both(mj, q, cell_size):
    """The slot ids the JAX package's gather_candidates looked up (read
    back from the gathered points) and the plain K1's; held equal, bit for
    bit: they are integers."""
    nb, B = mj.keys.shape
    cfg = JMapConfig(cell_size=cell_size, table_size=nb * B, bucket_size=B,
                     cell_capacity=1)
    cand, cvalid = jm.gather_candidates(mj, cfg, q)
    slots_j = np.where(np.asarray(cvalid),
                       np.asarray(cand)[:, :, 0].astype(np.int32), -1)
    slots_t = tm.octant_lookup(T(mj.keys), T(q), cell_size)
    assert slots_t.dtype == torch.int32
    np.testing.assert_array_equal(slots_t.numpy(), slots_j)
    return slots_j


@pytest.mark.parametrize("B", [32, 256])
def test_octant_lookup_reference_bucket_sizes(B):
    """The bucket sizes beside the presets' 128 that the kernel's generic
    instance serves."""
    rng = np.random.default_rng(B)
    mj = _slot_map(rng.integers(-7, 8, size=(1500, 3)), 64, B)
    q = rng.uniform(-8.0, 8.0, (500, 3)).astype(np.float32)
    slots = _slots_both(mj, q, 1.0)
    assert (slots >= 0).mean() > 0.2 and (slots < 0).any()


def test_octant_lookup_reference_duplicate_key():
    """A bucket row that holds a key twice resolves to the lower lane, as
    the JAX package's argmax over the row does."""
    nb, B = 64, 128
    mj = _slot_map(np.zeros((0, 3), np.int32), nb, B)
    packed = int(np.asarray(jm.pack_cells(np.array([2, -3, 1], np.int32))))
    b = int(np.asarray(jm._bucket_of(np.array([packed], np.int32), nb))[0])
    mj.keys[b, [70, 5]] = packed
    q = np.array([[2.25, -2.75, 1.25]], np.float32)
    slots = _slots_both(mj, q, 1.0)
    assert slots[0, 0] == b * B + 5 and (slots >= 0).sum() == 1
    np.testing.assert_array_equal(
        tm.lookup_packed(convert.voxel_map_from_numpy(mj),
                         T(np.array([packed], np.int32))).numpy(),
        np.asarray(jm.lookup_packed(mj, np.array([packed], np.int32))))


@pytest.mark.parametrize("cell_size", [1.0, 0.4])
def test_octant_lookup_reference_boundary_queries(cell_size):
    """Queries exactly on a cell boundary and on the half cell: the
    quotient's rounding decides the cell and the side."""
    rng = np.random.default_rng(11)
    mj = _slot_map(rng.integers(-6, 7, size=(1200, 3)), 64, 128)
    steps = np.arange(-10, 11, dtype=np.float32) * np.float32(0.5)
    g = np.stack(np.meshgrid(steps, steps[::3], steps[::5], indexing="ij"),
                 -1).reshape(-1, 3)
    q = (g * np.float32(cell_size)).astype(np.float32)
    slots = _slots_both(mj, q, cell_size)
    assert (slots >= 0).any() and (slots < 0).any()


def test_octant_lookup_reference_negative_and_wrapped_cells():
    """Cells below zero and on both sides of the +-512-cell wrap of the
    10-bit key fields."""
    edge = [-513, -512, -511, -2, -1, 0, 1, 510, 511, 512]
    cells = np.array([(x, y, z) for x in edge for y in (-1, 0, 511)
                      for z in (-512, 0)])
    mj = _slot_map(cells, 64, 128)
    rng = np.random.default_rng(3)
    q = np.stack([rng.choice(edge, 600) + rng.uniform(0, 1, 600),
                  rng.choice([-1, 0, 511], 600) + rng.uniform(0, 1, 600),
                  rng.choice([-512, 0], 600) + rng.uniform(0, 1, 600)],
                 1).astype(np.float32)
    slots = _slots_both(mj, q, 1.0)
    assert (slots >= 0).sum() > 600 and (slots < 0).any()
