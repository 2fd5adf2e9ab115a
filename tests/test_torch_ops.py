"""Parity of the port's low-level ops (pin_slam_tpu_torch.ops) with the JAX
package on identical numpy inputs: transforms (<= 1e-6), voxel hashing and
masks, Morton codes and the local-set build (exact)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pin_slam_tpu.ops import hash3d as jh
from pin_slam_tpu.ops import knn_join as jk
from pin_slam_tpu.ops import transforms as jt
from pin_slam_tpu.ops import voxel as jv
from pin_slam_tpu_torch.ops import hash3d as th
from pin_slam_tpu_torch.ops import knn_join as tkj
from pin_slam_tpu_torch.ops import transforms as tt
from pin_slam_tpu_torch.ops import voxel as tv


def _t(a):
    return torch.as_tensor(np.array(a))


def _rand_rot(rng, n):
    w = rng.randn(n, 3).astype(np.float32)
    return np.asarray(jt.so3_exp(jnp.asarray(w)))


class TestTransforms:
    @pytest.mark.parametrize("scale", [1e-7, 1e-3, 1.0, 3.0])
    def test_so3_exp(self, scale):
        w = (np.random.RandomState(0).randn(64, 3) * scale).astype(np.float32)
        np.testing.assert_allclose(tt.so3_exp(_t(w)).numpy(),
                                   np.asarray(jt.so3_exp(jnp.asarray(w))),
                                   atol=1e-6)

    def test_se3_exp_and_angle(self):
        xi = np.random.RandomState(1).randn(16, 6).astype(np.float32)
        T = tt.se3_exp(_t(xi))
        np.testing.assert_allclose(T.numpy(),
                                   np.asarray(jt.se3_exp(jnp.asarray(xi))),
                                   atol=1e-6)
        np.testing.assert_allclose(
            tt.rotation_angle(T[:, :3, :3]).numpy(),
            np.asarray(jt.rotation_angle(jnp.asarray(T.numpy()[:, :3, :3]))),
            atol=1e-6)

    def test_transform_points(self):
        rng = np.random.RandomState(2)
        T = np.eye(4, dtype=np.float32)
        T[:3, :3] = _rand_rot(rng, 1)[0]
        T[:3, 3] = rng.randn(3)
        p = rng.randn(100, 3).astype(np.float32) * 10
        np.testing.assert_allclose(
            tt.transform_points(_t(p), _t(T)).numpy(),
            np.asarray(jt.transform_points(jnp.asarray(p), jnp.asarray(T))),
            atol=1e-5)

    def test_transform_points_batch(self):
        rng = np.random.RandomState(5)
        T = np.tile(np.eye(4, dtype=np.float32), (200, 1, 1))
        T[:, :3, :3] = _rand_rot(rng, 200)
        T[:, :3, 3] = rng.randn(200, 3)
        p = rng.randn(200, 3).astype(np.float32) * 10
        np.testing.assert_allclose(
            tt.transform_points_batch(_t(p), _t(T)).numpy(),
            np.asarray(jt.transform_points_batch(jnp.asarray(p),
                                                 jnp.asarray(T))),
            atol=1e-5)

    def test_transform_points_by_ts(self):
        """Per-point transforms by timestamp, the timestamps past T-1 and
        below 0 clipped: within 1e-6 of the JAX package (positions of a few
        metres, so a float32 ulp is <= 5e-7)."""
        rng = np.random.RandomState(6)
        nT = 12
        D = np.tile(np.eye(4, dtype=np.float32), (nT, 1, 1))
        D[:, :3, :3] = np.asarray(jt.so3_exp(
            jnp.asarray(rng.randn(nT, 3).astype(np.float32) * 0.05)))
        D[:, :3, 3] = rng.randn(nT, 3) * 0.2
        p = rng.uniform(-3.5, 3.5, (5000, 3)).astype(np.float32)
        ts = rng.randint(-2, nT + 5, 5000).astype(np.int32)
        got = tt.transform_points_by_ts(_t(p), _t(ts), _t(D)).numpy()
        ref = np.asarray(jt.transform_points_by_ts(
            jnp.asarray(p), jnp.asarray(ts), jnp.asarray(D)))
        np.testing.assert_allclose(got, ref, atol=1e-6, rtol=0)
        tc = np.clip(ts, 0, nT - 1)
        np.testing.assert_allclose(
            got, np.einsum("nij,nj->ni", D[tc, :3, :3], p) + D[tc, :3, 3],
            atol=1e-5)

    def test_np_rotmat_to_quat(self):
        R = _rand_rot(np.random.RandomState(8), 500)
        np.testing.assert_allclose(
            tt.np_rotmat_to_quat(R),
            np.asarray(jt.rotmat_to_quat(jnp.asarray(R))), atol=2.4e-7,
            rtol=0)

    def test_quaternions(self):
        rng = np.random.RandomState(3)
        R = _rand_rot(rng, 50)
        qt = tt.rotmat_to_quat(_t(R)).numpy()
        np.testing.assert_allclose(
            qt, np.asarray(jt.rotmat_to_quat(jnp.asarray(R))), atol=1e-6)
        q2 = np.asarray(jt.rotmat_to_quat(jnp.asarray(_rand_rot(rng, 50))))
        np.testing.assert_allclose(
            tt.quat_multiply(_t(qt), _t(q2)).numpy(),
            np.asarray(jt.quat_multiply(jnp.asarray(qt), jnp.asarray(q2))),
            atol=1e-6)
        v = rng.randn(50, 3).astype(np.float32)
        np.testing.assert_allclose(
            tt.quat_rotate(_t(qt), _t(v)).numpy(),
            np.asarray(jt.quat_rotate(jnp.asarray(qt), jnp.asarray(v))),
            atol=1e-5)

    def test_numpy_helpers(self):
        rng = np.random.RandomState(4)
        T = np.eye(4)
        T[:3, :3] = _rand_rot(rng, 1)[0].astype(np.float64)
        T[:3, 3] = rng.randn(3)
        np.testing.assert_array_equal(tt.np_se3_inv(T), jt.np_se3_inv(T))
        assert tt.np_rotation_angle_deg(T) == jt.np_rotation_angle_deg(T)
        r = np.linspace(0, 1, 7)
        np.testing.assert_array_equal(tt.np_slerp_rotmats(T[:3, :3], r),
                                      jt.np_slerp_rotmats(T[:3, :3], r))


class TestHashAndVoxel:
    @pytest.mark.parametrize("res", [0.08, 0.3, 0.4])
    def test_grid_and_hash(self, res):
        p = (np.random.RandomState(5).rand(5000, 3) * 200 - 100).astype(
            np.float32)
        g_j = np.asarray(jh.grid_coords(jnp.asarray(p), res))
        g_t = th.grid_coords(_t(p), res).numpy()
        np.testing.assert_array_equal(g_t, g_j)
        for size in (1 << 10, 1 << 18, 1 << 23):
            np.testing.assert_array_equal(
                th.hash_grid(_t(g_t), size).numpy(),
                np.asarray(jh.hash_grid(jnp.asarray(g_j), size)))
        assert th.max_valid_dist2(2, res) == jh.max_valid_dist2(2, res)

    @pytest.mark.parametrize("table", [1 << 8, 1 << 21])
    def test_hash_mask(self, table):
        rng = np.random.RandomState(6)
        p = (rng.rand(20000, 3) * 20 - 10).astype(np.float32)
        m = rng.rand(20000) < 0.8
        np.testing.assert_array_equal(
            tv.voxel_down_sample_hash_mask(_t(p), _t(m), 0.3, table).numpy(),
            np.asarray(jv.voxel_down_sample_hash_mask(
                jnp.asarray(p), jnp.asarray(m), 0.3, table)))

    def test_min_value_mask(self):
        rng = np.random.RandomState(7)
        p = (rng.rand(8000, 3) * 6).astype(np.float32)
        m = rng.rand(8000) < 0.9
        val = rng.randint(0, 5, 8000).astype(np.float32)   # many ties
        np.testing.assert_array_equal(
            tv.voxel_down_sample_min_value_mask(_t(p), _t(m), 0.4,
                                                _t(val)).numpy(),
            np.asarray(jv.voxel_down_sample_min_value_mask(
                jnp.asarray(p), jnp.asarray(m), 0.4, jnp.asarray(val))))

    def test_compact_mask(self):
        m = np.random.RandomState(8).rand(3000) < 0.3
        d_t, n_t = tv.compact_mask(_t(m), 500)
        d_j, n_j = jv.compact_mask(jnp.asarray(m), 500)
        np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
        assert int(n_t) == int(n_j)


class TestMortonAndLocalSet:
    def test_morton_sort(self):
        rng = np.random.RandomState(9)
        p = (rng.rand(6000, 3) * 50 - 25).astype(np.float32)
        p[:600] = p[600:1200]                     # duplicate codes -> ties
        valid = rng.rand(6000) < 0.85
        g = np.clip(np.floor((p + 25) / 1.6), 0, 1023).astype(np.int32)
        np.testing.assert_array_equal(
            tkj._morton10(_t(g)).numpy(),
            np.asarray(jk._morton10(jnp.asarray(g))))
        np.testing.assert_array_equal(
            tkj._sort_by_morton(_t(p), _t(valid), 1.6).numpy(),
            np.asarray(jk._sort_by_morton(jnp.asarray(p), jnp.asarray(valid),
                                          1.6)))

    @pytest.mark.parametrize("C,n,cap", [(4096, 3000, 2048),
                                         (1100, 1090, 1 << 17),
                                         (200, 64, 4096)])
    def test_build_local_set(self, C, n, cap):
        rng = np.random.RandomState(C)
        pos = np.zeros((C + 1, 3), np.float32)
        pos[:n] = rng.rand(n, 3).astype(np.float32) * 30
        mask = np.zeros(C, bool)
        mask[:n] = rng.rand(n) < 0.9
        cert = rng.rand(C + 1).astype(np.float32)
        q = rng.randn(C + 1, 4).astype(np.float32)
        ls_t = tkj.build_local_set(_t(pos), _t(mask), 0.4, cap,
                                   certainty=_t(cert), orientations=_t(q))
        ls_j = jk.build_local_set(jnp.asarray(pos), jnp.asarray(mask), 0.4,
                                  cap, certainty=jnp.asarray(cert),
                                  orientations=jnp.asarray(q))
        assert ls_t.cap == ls_j.cap
        assert int(ls_t.count) == int(ls_j.count)
        for a, b in ((ls_t.pts, ls_j.pts), (ls_t.gidx, ls_j.gidx),
                     (ls_t.cert, ls_j.cert), (ls_t.quat, ls_j.quat)):
            np.testing.assert_array_equal(a.numpy(), np.asarray(b))

    def test_pair_rows(self):
        rng = np.random.RandomState(10)
        L = 4096
        lp = (rng.rand(L, 3) * 40).astype(np.float32)
        si = np.asarray(jk._sort_by_morton(jnp.asarray(lp),
                                           jnp.ones(L, bool), 1.6))
        lp = lp[si]
        q = np.concatenate([lp[rng.randint(0, L, 1000)]
                            + rng.randn(1000, 3).astype(np.float32) * 0.3,
                            np.full((24, 3), 1e9, np.float32)])
        tab_j, bbd_j = jk._build_pair_rows(jnp.asarray(q), jnp.asarray(lp),
                                           1.44)
        tab_t, bbd_t = tkj._build_pair_rows(_t(q), _t(lp), 1.44)
        np.testing.assert_array_equal(tab_t.numpy(), np.asarray(tab_j).T)
        np.testing.assert_array_equal(bbd_t.numpy(), np.asarray(bbd_j).T)


@pytest.mark.parametrize("cols", [0, 1, 8])
def test_index_add_exact_is_order_free(cols):
    """The fixed-point scatter-add gives the same bits in any order of its
    inputs and agrees with a float64 sum to float32 rounding of the result
    (rtol 1e-6); rows of zeros (the callers' padding, sent to one dump row)
    change nothing."""
    from pin_slam_tpu_torch.ops.scatter import index_add_exact

    rng = np.random.RandomState(cols)
    m, rows = 20000, 40
    idx = rng.randint(0, rows - 1, m)
    src = (rng.randn(m, max(cols, 1)) * 10.0 ** rng.uniform(-9, -4, (m, 1))
           ).astype(np.float32)
    dead = rng.rand(m) < 0.3
    idx[dead] = rows - 1
    src[dead] = 0.0
    if cols == 0:
        src = src[:, 0]
    dst = rng.randn(rows, *src.shape[1:]).astype(np.float32)
    want = dst.astype(np.float64)
    np.add.at(want, idx, src.astype(np.float64))
    got = index_add_exact(torch.as_tensor(dst), torch.as_tensor(idx),
                          torch.as_tensor(src))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-12)
    np.testing.assert_array_equal(got.numpy()[rows - 1], dst[rows - 1])
    perm = rng.permutation(m)
    again = index_add_exact(torch.as_tensor(dst), torch.as_tensor(idx[perm]),
                            torch.as_tensor(src[perm]))
    assert torch.equal(got, again)
    empty = index_add_exact(torch.as_tensor(dst), torch.zeros(0).long(),
                            torch.as_tensor(src[:0]))
    assert torch.equal(empty, torch.as_tensor(dst))


def test_index_add_exact_keeps_small_destinations():
    """A destination that only small values reach keeps their sum to
    float32 rounding, however large the values sent to other destinations,
    and the sums are the same in any order: with `per_destination`, and in
    the default form. (Scaled by the largest value of all alone, sums 1e-13
    of it flush to zero; Adam turns such a gradient into a full step, so
    the JAX package's float sums and the port's must agree on it.)"""
    from pin_slam_tpu_torch.ops.scatter import index_add_exact

    rng = np.random.RandomState(5)
    m = 3000
    idx = rng.randint(0, 4, m)
    mag = np.array([1.0, 1e-17, 1e-30, 1e-4])[idx]
    src = (rng.randn(m, 2) * mag[:, None]).astype(np.float32)
    want = np.zeros((4, 2))
    np.add.at(want, idx, src.astype(np.float64))
    got = index_add_exact(torch.zeros(4, 2), torch.as_tensor(idx),
                          torch.as_tensor(src), per_destination=True)
    assert (got.numpy() != 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    perm = rng.permutation(m)
    again = index_add_exact(torch.zeros(4, 2), torch.as_tensor(idx[perm]),
                            torch.as_tensor(src[perm]), per_destination=True)
    assert torch.equal(got, again)
    # the default keeps one scale (2**-39 of the largest value) wherever it
    # leaves float32's 24 bits, bit for bit, and sums the other
    # destinations (1e-17, 1e-30) again with their own scale, where that
    # one scale would flush them to 0
    got = index_add_exact(torch.zeros(4, 2), torch.as_tensor(idx),
                          torch.as_tensor(src))
    assert (got.numpy() != 0).all()
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=0)
    q = 2.0 ** (int(np.frexp(np.abs(src).max())[1]) - 39)
    single = np.zeros((4, 2))
    np.add.at(single, idx, np.round(src.astype(np.float64) / q))
    single = (single * q).astype(np.float32)
    assert (single[1:3] == 0).all()
    np.testing.assert_array_equal(got.numpy()[[0, 3]], single[[0, 3]])
    again = index_add_exact(torch.zeros(4, 2), torch.as_tensor(idx[perm]),
                            torch.as_tensor(src[perm]))
    assert torch.equal(got, again)
