"""The four CUDA kernels against their plain PyTorch versions on the card,
at shapes and cases the main path does not reach: odd query counts, other
cell capacities, k = 10, missing slots, tied distances, and the wrappers'
input checks.  Needs a CUDA device and nvcc; elsewhere every test skips.

Run on the GPU machine (no JAX there, so without the JAX conftest):

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_kernels_cuda.py
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from superodom_tpu_torch import kernels, mapstate, registration  # noqa: E402
from superodom_tpu_torch.config import MapConfig  # noqa: E402
from superodom_tpu_torch.geometry import Pose, quat_mul, so3_exp  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the hand-written kernels run "
                    "only on the card")
    return torch.device("cuda")


def _map(dev, cap, seed):
    """A map filled by the port's insert from clustered random points."""
    cfg = MapConfig(cell_size=1.0, table_size=1 << 12, cell_capacity=cap)
    g = torch.Generator(device="cpu").manual_seed(seed)
    centers = torch.rand((40, 3), generator=g) * 12.0 - 6.0
    pts = (centers[torch.randint(0, 40, (4000,), generator=g)]
           + 0.4 * torch.randn((4000, 3), generator=g)).to(dev)
    m = mapstate.empty_map(cfg, device=dev)
    for i in range(4):
        sl = slice(1000 * i, 1000 * (i + 1))
        m = mapstate.insert(m, cfg, pts[sl].contiguous(),
                            torch.ones(1000, dtype=torch.bool, device=dev),
                            torch.tensor(0.05, device=dev))
    q = (pts[:333] + 0.1 * torch.randn((333, 3), generator=g).to(dev))
    return cfg, m, q.contiguous()


@pytest.mark.parametrize("cap,k", [(16, 5), (24, 10), (32, 5)])
def test_lookup_and_select_match_plain(dev, cap, k):
    cfg, m, q = _map(dev, cap, seed=cap)
    s_k = kernels.octant_lookup(m.keys, q, cfg.cell_size)
    s_r = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    assert torch.equal(s_k, s_r) and (s_r >= 0).any() and (s_r < 0).any()
    out_k = kernels.knn_select(m.pts, s_r, q, k)
    out_r = mapstate.knn_select_reference(m.pts, s_r, q, k)
    for a, b in zip(out_k, out_r):
        assert torch.equal(a, b)


def test_select_ties_go_to_the_lower_lane(dev):
    C = 8
    pts = torch.full((64, 3 * C), 1e30, device=dev)
    offs = torch.tensor([[0.5, 0, 0], [0, 0.5, 0], [0, 0, 0.5], [-0.5, 0, 0],
                         [0, -0.5, 0], [0, 0, -0.5], [1, 0, 0], [0, 1, 0]],
                        device=dev)
    for row in (3, 9):
        for j in range(C):
            for a in range(3):
                pts[row, a * C + j] = 1.0 + offs[(j + row) % 8, a]
    slots = torch.tensor([[3, -1, 9, -1, -1, 3, -1, -1]], dtype=torch.int32,
                         device=dev)
    q = torch.ones((1, 3), device=dev)
    out_k = kernels.knn_select(pts, slots, q, 8)
    out_r = mapstate.knn_select_reference(pts, slots, q, 8)
    for a, b in zip(out_k, out_r):
        assert torch.equal(a, b)
    assert torch.all(out_k[1] == 0.25)
    assert torch.all(out_k[3][0, 1:] > out_k[3][0, :-1])


def test_plane_fit_and_normal_system_match_plain(dev):
    cfg, m, q = _map(dev, 16, seed=5)
    slots = mapstate.octant_lookup_reference(m.keys, q, cfg.cell_size)
    neigh, sq, nvalid, _ = mapstate.knn_select_reference(m.pts, slots, q, 5)
    mask = torch.arange(q.shape[0], device=dev) % 7 != 0
    pose = Pose(quat_mul(so3_exp(torch.tensor([0.01, -0.02, 0.03],
                                              device=dev)),
                         torch.tensor([1.0, 0, 0, 0], device=dev)),
                torch.tensor([0.1, -0.2, 0.05], device=dev))
    res = torch.tensor(0.3, device=dev)
    args = (neigh.contiguous(), sq.contiguous(), nvalid.contiguous(), mask,
            q, pose.q.contiguous(), res)
    out_k = kernels.plane_fit(*args)
    out_r = registration.plane_fit_reference(*args)
    for a, b in zip(out_k, out_r):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
    assert out_r[3].sum() > 10
    args4 = (q, out_r[0].contiguous(), out_r[1], out_r[2], out_r[3],
             pose.q.contiguous(), pose.t.contiguous(), 3.0 * res)
    with pytest.raises(ValueError):  # the wrappers take contiguous inputs
        kernels.plane_fit(neigh, sq, *args[2:])
    H_k, g_k, c_k = kernels.normal_system(*args4)
    H_r, g_r, c_r = registration.normal_system_reference(*args4)
    scale = float(H_r.abs().max())
    assert float((H_k - H_r).abs().max()) <= 1e-5 * scale
    assert float((g_k - g_r).abs().max()) <= 1e-5 * float(g_r.abs().max())
    assert torch.equal(H_k, kernels.normal_system(*args4)[0])  # no atomics


def test_wrappers_check_inputs_and_count(dev):
    cfg, m, q = _map(dev, 16, seed=7)
    before = dict(kernels.launch_counts)
    kernels.octant_lookup(m.keys, q, cfg.cell_size)
    assert kernels.launch_counts["octant_lookup"] == \
        before["octant_lookup"] + 1
    with pytest.raises(ValueError):
        kernels.octant_lookup(m.keys, q.double(), cfg.cell_size)
    with pytest.raises(ValueError):
        kernels.octant_lookup(m.keys, q.t(), cfg.cell_size)
    with pytest.raises(ValueError):
        kernels.knn_select(m.pts, torch.zeros((5, 8), dtype=torch.int32,
                                              device=dev), q, 5)
    with pytest.raises(ValueError):
        kernels.octant_lookup(m.keys.cpu(), q, cfg.cell_size)
    # a CUDA tensor always reaches the kernel through the dispatcher
    n = kernels.launch_counts["octant_lookup"]
    mapstate.octant_lookup(m.keys, q, cfg.cell_size)
    assert kernels.launch_counts["octant_lookup"] == n + 1
    assert np.isfinite(kernels.build_seconds or 0.0)
