"""Geometry, hashing and small linear algebra of the PyTorch port against
the JAX package, on seeded random batches (1e-5 relative; hashes and
voxel coordinates bit-exact)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(2)

from superodom_tpu import geometry as jg  # noqa: E402
from superodom_tpu import mapstate as jm  # noqa: E402
from superodom_tpu.ops.eigh3 import eigh3 as j_eigh3  # noqa: E402
from superodom_tpu.ops import smallsolve as jss  # noqa: E402
from superodom_tpu.ops import voxel as jv  # noqa: E402

from superodom_tpu_torch import geometry as tg  # noqa: E402
from superodom_tpu_torch import mapstate as tm  # noqa: E402
from superodom_tpu_torch.ops import eigh3 as te  # noqa: E402
from superodom_tpu_torch.ops import smallsolve as tss  # noqa: E402
from superodom_tpu_torch.ops import voxel as tv  # noqa: E402

RTOL, ATOL = 1e-5, 1e-6


def T(a):
    return torch.from_numpy(np.array(a))


def close(t, j, rtol=RTOL, atol=ATOL):
    np.testing.assert_allclose(np.asarray(t), np.asarray(j), rtol=rtol,
                               atol=atol)


def _quats(rng, n):
    q = rng.normal(size=(n, 4)).astype(np.float32)
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


def _rotvecs(rng, n):
    """Axis-angle vectors: generic, near identity and near pi."""
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=-1, keepdims=True)
    ang = np.concatenate([rng.uniform(0.0, 3.0, n - n // 2),
                          rng.uniform(0.0, 1e-4, n // 4),
                          np.pi - rng.uniform(1e-3, 1e-2, n // 4)])
    return (axis * ang[:, None]).astype(np.float32)


def test_quaternion_ops():
    rng = np.random.default_rng(0)
    q, p = _quats(rng, 64), _quats(rng, 64)
    v = rng.normal(size=(64, 3)).astype(np.float32)
    close(tg.quat_mul(T(q), T(p)), jg.quat_mul(q, p))
    close(tg.quat_conj(T(q)), jg.quat_conj(q))
    close(tg.quat_normalize(T(3.0 * q)), jg.quat_normalize(3.0 * q))
    close(tg.quat_rotate(T(q), T(v)), jg.quat_rotate(q, v))
    close(tg.quat_to_matrix(T(q)), jg.quat_to_matrix(q))
    R = np.asarray(jg.quat_to_matrix(q))
    close(tg.matrix_to_quat(T(R)), jg.matrix_to_quat(R))
    close(tg.quat_angle(T(q)), jg.quat_angle(q))
    t = rng.uniform(0.0, 1.0, 64).astype(np.float32)
    close(tg.quat_slerp(T(q), T(p), T(t)), jg.quat_slerp(q, p, t))
    close(tg.quat_slerp(T(q), T(q), T(t)), jg.quat_slerp(q, q, t))


def test_rpy_round_trip():
    rng = np.random.default_rng(1)
    rpy = rng.uniform(-1.4, 1.4, size=(3, 32)).astype(np.float32)
    qt = tg.quat_from_rpy(*(T(a) for a in rpy))
    qj = jg.quat_from_rpy(*rpy)
    close(qt, qj)
    for a, b in zip(tg.rpy_from_quat(qt), jg.rpy_from_quat(qj)):
        close(a, b, atol=1e-5)


def test_so3_exp_log():
    rng = np.random.default_rng(2)
    w = _rotvecs(rng, 64)
    close(tg.so3_exp(T(w)), jg.so3_exp(w))
    q = np.asarray(jg.so3_exp(w))
    close(tg.so3_log(T(q)), jg.so3_log(q), atol=1e-5)
    close(tg.skew(T(w)), jg.skew(w))


def test_se3_update_and_pose():
    rng = np.random.default_rng(3)
    xi = np.concatenate([rng.normal(size=(16, 3)), _rotvecs(rng, 16)],
                        axis=-1).astype(np.float32)
    q = _quats(rng, 16)
    t = rng.normal(size=(16, 3)).astype(np.float32)
    for i in range(16):
        pt = tg.apply_se3_update(tg.Pose(T(q[i]), T(t[i])), T(xi[i]))
        pj = jg.apply_se3_update(jg.Pose(q[i], t[i]), xi[i])
        close(pt.q, pj.q)
        close(pt.t, pj.t, atol=1e-5)
    a = tg.Pose(T(q[0]), T(t[0]))
    b = tg.Pose(T(q[1]), T(t[1]))
    aj, bj = jg.Pose(q[0], t[0]), jg.Pose(q[1], t[1])
    c, cj = a.inverse().compose(b), aj.inverse().compose(bj)
    close(c.q, cj.q)
    close(c.t, cj.t)
    close(a.apply(T(t)), aj.apply(t), atol=1e-5)
    for x, y in zip(tg.pose_delta(a, b), jg.pose_delta(aj, bj)):
        close(x, y)


def test_voxel_coords_and_hashes_bit_exact():
    rng = np.random.default_rng(4)
    xyz = rng.uniform(-300.0, 300.0, size=(4096, 3)).astype(np.float32)
    for res in (0.1, 0.2, 2.0):
        ct = tv.voxel_coords(T(xyz), res)
        cj = np.asarray(jv.voxel_coords(xyz, res))
        np.testing.assert_array_equal(ct.numpy(), cj)
        for variant in (0, 1):
            np.testing.assert_array_equal(
                tv.hash_coords(ct, variant).numpy(),
                np.asarray(jv.hash_coords(cj, variant)))
    big = rng.integers(-2 ** 31, 2 ** 31 - 1, size=(512, 3)).astype(np.int32)
    np.testing.assert_array_equal(tv.hash_coords(T(big), 1).numpy(),
                                  np.asarray(jv.hash_coords(big, 1)))


def test_pack_and_bucket_bit_exact():
    rng = np.random.default_rng(5)
    cells = rng.integers(-600, 600, size=(4096, 3)).astype(np.int32)
    pt = tm.pack_cells(T(cells))
    pj = np.asarray(jm.pack_cells(cells))
    np.testing.assert_array_equal(pt.numpy(), pj)
    np.testing.assert_array_equal(tm.unpack_cells(pt).numpy(),
                                  np.asarray(jm.unpack_cells(pj)))
    for nb in (8, 512):
        np.testing.assert_array_equal(tm._bucket_of(pt, nb).numpy(),
                                      np.asarray(jm._bucket_of(pj, nb)))
    np.testing.assert_array_equal(
        tm._bucket_scramble(pt).numpy(),
        np.asarray(jm._bucket_scramble(pj)).astype(np.int64))


def test_composite_sort_order():
    rng = np.random.default_rng(6)
    h1 = rng.integers(0, 20, 1000).astype(np.int32)
    h2 = rng.integers(0, 20, 1000).astype(np.int32)
    np.testing.assert_array_equal(
        tv._composite_sort_order(T(h1), T(h2)).numpy(),
        np.asarray(jv._composite_sort_order(h1, h2)))


def _spd3(rng, n):
    Q = np.linalg.qr(rng.normal(size=(n, 3, 3)))[0]
    ev = np.sort(rng.uniform(0.01, 4.0, size=(n, 3)), axis=-1)
    ev[:, 1] += 0.3  # separated eigenvalues: vectors are well defined
    ev[:, 2] += 0.6
    return (Q * ev[:, None, :] @ np.swapaxes(Q, 1, 2)).astype(np.float32)


def test_eigh3():
    rng = np.random.default_rng(7)
    A = _spd3(rng, 256)
    vt, Vt = te.eigh3(T(A))
    vj, Vj = j_eigh3(A)
    close(vt, vj, rtol=1e-5, atol=1e-5)
    # eigenvectors agree up to sign
    dots = np.abs(np.sum(Vt.numpy() * np.asarray(Vj), axis=-2))
    np.testing.assert_allclose(dots, 1.0, atol=1e-4)
    # degenerate inputs take the same fallbacks
    iso = np.broadcast_to(np.eye(3, dtype=np.float32), (4, 3, 3)).copy()
    iso[1] = 0.0
    iso[2] = np.diag([1.0, 2.0, 3.0]).astype(np.float32)
    for a, b in zip(te.eigh3(T(iso)), j_eigh3(iso)):
        close(a, b, atol=1e-6)


def _spd6(rng, n):
    M = rng.normal(size=(n, 6, 6))
    return (M @ np.swapaxes(M, 1, 2) + 2.0 * np.eye(6)).astype(np.float32)


def test_solve6_and_inv6():
    rng = np.random.default_rng(8)
    H = _spd6(rng, 16)
    g = rng.normal(size=(16, 6)).astype(np.float32)
    for i in range(16):
        close(tss.solve6_spd(T(H[i]), T(g[i])), jss.solve6_spd(H[i], g[i]))
        close(tss.inv6_spd(T(H[i])), jss.inv6_spd(H[i]))
    # batched call agrees with the per-matrix calls
    close(tss.solve6_spd(T(H), T(g)),
          np.stack([np.asarray(jss.solve6_spd(H[i], g[i]))
                    for i in range(16)]))
    I6 = np.eye(6, dtype=np.float32)
    close(tss.inv6_spd(T(H[0])).numpy() @ H[0], I6, atol=1e-4)
