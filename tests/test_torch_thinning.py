"""Feature selection of the PyTorch port against the JAX package:
``thin_and_select`` in its four modes and through the ``compact_width``
pre-compaction (lane sets exact; centroid lanes 1e-6), on a real scan in
range mode, and the adaptive voxel size on a near and a far cloud."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from superodom_tpu import config as jcfg  # noqa: E402
from superodom_tpu import frontend as jf  # noqa: E402
from superodom_tpu import pipeline as jp  # noqa: E402

from superodom_tpu_torch import config as tcfg  # noqa: E402
from superodom_tpu_torch import frontend as tf  # noqa: E402
from superodom_tpu_torch import pipeline as tp  # noqa: E402

from test_torch_frontend_inertial import _scan, data  # noqa: E402,F401
from test_torch_voxel import N_CLOUD, T, _cloud  # noqa: E402


def test_thin_and_select_range_mode(data):
    ds, _ = data
    xyz, t_rel, mask = _scan(ds, 9)
    out_t = tf.thin_and_select(T(xyz), T(mask), torch.tensor(0.2), 512, 4096,
                               T(t_rel), mode="range")
    out_j = jf.thin_and_select(xyz, mask, 0.2, 512, 4096, t_rel,
                               mode="range")
    for a, b in zip(out_t, out_j):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # the other three modes: test_thin_and_select_modes below
    with pytest.raises(ValueError):
        tf.thin_and_select(T(xyz), T(mask), 0.2, 512, 4096, mode="octree")


THIN_CASES = {
    # name: (mode, compact_width): 4096 leaves the 3,000 lanes alone, 1024
    # compacts them first
    "voxel": ("voxel", 4096),
    "voxel_compacted": ("voxel", 1024),
    "centroid": ("centroid", 4096),
    "centroid_compacted": ("centroid", 1024),
    "range": ("range", 4096),
    "none": ("none", 4096),
}


@pytest.mark.parametrize("case", list(THIN_CASES))
def test_thin_and_select_modes(case):
    mode, width = THIN_CASES[case]
    xyz, mask, t_rel = _cloud(4)
    bits = max((4 * N_CLOUD * 3 - 1).bit_length(), 4)  # a 3x wider sensor's table
    out_j = jf.thin_and_select(xyz, mask, np.float32(0.2), 512, width, t_rel,
                               mode=mode, table_bits=bits)
    out_t = tf.thin_and_select(T(xyz), T(mask), torch.tensor(0.2), 512, width,
                               T(t_rel), mode=mode, table_bits=bits)
    assert len(out_t) == 3 and out_t[0].shape == (512, 3)
    np.testing.assert_array_equal(out_t[1].numpy(), np.asarray(out_j[1]))
    assert 100 < int(out_t[1].sum()) <= 512
    if mode == "centroid":  # lanes are means: 1e-6
        for a, b in zip(out_t, out_j):
            np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    else:  # lanes are input lanes: exact
        for a, b in zip(out_t, out_j):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("scale,expect", [(0.25, (0.1, 0.2)),
                                          (1.0, (0.3, 0.6)),
                                          (2.5, (0.4, 0.8))],
                         ids=["near", "between", "far"])
def test_adjust_voxel_size_auto(scale, expect):
    """auto_voxel_size: the product of the per-axis mean |coordinate|
    selects the near preset (< 25), the far one (> 65), or keeps the
    running resolutions."""
    xyz, mask, _ = _cloud(6)
    xyz = (np.abs(xyz) * np.float32(scale) + np.float32(0.5)).astype(
        np.float32)
    cfg_j = jcfg.PipelineConfig(auto_voxel_size=True)
    cfg_t = tcfg.PipelineConfig(auto_voxel_size=True)
    rt_j, avg_j = jp._adjust_voxel_size(
        cfg_j, jcfg.RuntimeParams(np.float32(0.3), np.float32(0.6)), xyz, mask)
    rt_t, avg_t = tp._adjust_voxel_size(
        cfg_t, tcfg.RuntimeParams(torch.tensor(0.3), torch.tensor(0.6)),
        T(xyz), T(mask))
    np.testing.assert_allclose(float(avg_t), float(avg_j), rtol=1e-5)
    assert rt_t.line_res.dtype == torch.float32 and rt_t.line_res.dim() == 0
    for got, want_j, want in zip(rt_t, rt_j, expect):
        assert float(got) == float(np.float32(want_j)) == float(
            np.float32(want))
    # off: the running resolutions pass through untouched
    off = dataclasses.replace(cfg_t, auto_voxel_size=False)
    rt0 = tcfg.RuntimeParams(torch.tensor(0.3), torch.tensor(0.6))
    assert tp._adjust_voxel_size(off, rt0, T(xyz), T(mask))[0] is rt0
