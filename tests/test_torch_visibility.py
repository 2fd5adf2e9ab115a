"""The port's visibility test (pin_slam_tpu_torch.ops.visibility) against
the JAX package's, on the CPU.

* The analytic cases of tests/test_visibility.py (a ring wall around an
  origin, a plate, a holed wall) through both packages: each verdict is the
  expected one in both.
* `_spherical_bins`: on points whose azimuth and elevation bin coordinates
  lie at least 1e-4 of a bin from an edge, the bins and the in-FOV mask are
  equal. Over uniformly random directions, where some points sit within
  float rounding of an edge (atan2 and asin round differently in XLA and in
  torch), at most 0.1 % of the bins differ, each by one bin.
* `render_min_range_bins` on an off-edge map: the same empty bins, ranges
  to 1e-6 relative (the norm's rounding).
* `visibility_free_mask` on a random map and random queries: equal, apart
  from queries within 1e-4 m of a decision threshold (none here).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pin_slam_tpu.ops import visibility as jv
from pin_slam_tpu_torch.ops import visibility as tv

EL = 0.6
N_AZ, N_EL = 256, 32


def ring_wall(radius=20.0, n=4000, z_lo=-2.0, z_hi=2.0, seed=0):
    rng = np.random.RandomState(seed)
    az = rng.uniform(-np.pi, np.pi, n)
    z = rng.uniform(z_lo, z_hi, n)
    return np.stack([radius * np.cos(az), radius * np.sin(az), z], 1)


def _plate_map():
    plate = np.stack([np.full(200, 5.0),
                      np.random.RandomState(1).uniform(-1, 1, 200),
                      np.random.RandomState(2).uniform(-1, 1, 200)], 1)
    return np.concatenate([ring_wall(), plate])


def _holed_wall():
    wall = ring_wall(n=20000)
    az = np.arctan2(wall[:, 1], wall[:, 0])
    return wall[np.abs(az) > 0.012]


def _sector_wall():
    wall = ring_wall()
    return wall[np.arctan2(wall[:, 1], wall[:, 0]) > 2.0]


def judge_jax(origins, map_pts, queries, **kw):
    o = jnp.asarray(origins, jnp.float32)
    pts = jnp.asarray(map_pts, jnp.float32)
    q = jnp.asarray(queries, jnp.float32)
    img = jv.render_min_range_bins(o, pts, jnp.ones(pts.shape[0], bool),
                                   n_az=N_AZ, n_el=N_EL, el_lo=-EL, el_hi=EL)
    return np.asarray(jv.visibility_free_mask(
        o, img, q, jnp.ones(q.shape[0], bool), el_lo=-EL, el_hi=EL, **kw))


def judge_torch(origins, map_pts, queries, **kw):
    o = torch.as_tensor(np.asarray(origins, np.float32))
    pts = torch.as_tensor(np.asarray(map_pts, np.float32))
    q = torch.as_tensor(np.asarray(queries, np.float32))
    img = tv.render_min_range_bins(o, pts, torch.ones(pts.shape[0],
                                                      dtype=torch.bool),
                                   n_az=N_AZ, n_el=N_EL, el_lo=-EL, el_hi=EL)
    return tv.visibility_free_mask(
        o, img, q, torch.ones(q.shape[0], dtype=torch.bool), el_lo=-EL,
        el_hi=EL, **kw).numpy()


# (name, origins, map, queries, kwargs, expected verdicts): the cases of
# tests/test_visibility.py
CASES = [
    ("front_of_wall_is_free", [[0, 0, 0]], ring_wall,
     [[12.0, 0, 0], [0, -10.0, 0.5]], {}, [True, True]),
    ("wall_hit_and_behind_wall_are_static", [[0, 0, 0]], ring_wall,
     [[19.9, 0, 0], [21.5, 0, 0]], {}, [False, False]),
    ("beyond_judge_range_is_static", [[0, 0, 0]],
     lambda: ring_wall(radius=40.0), [[25.0, 0, 0]],
     {"max_judge_range": 22.0}, [False]),
    ("out_of_elevation_fov_is_static", [[0, 0, 0]], ring_wall,
     [[2.0, 0, 5.0]], {}, [False]),
    ("empty_bins_unjudgeable", [[0, 0, 0]], _sector_wall, [[12.0, 0, 0]],
     {}, [False]),
    ("occluded_from_one_origin", [[0, 0, 0]], _plate_map, [[12.0, 0, 0]],
     {}, [False]),
    ("second_origin_one_vote", [[0, 0, 0], [0, 14.0, 0]], _plate_map,
     [[12.0, 0, 0]], {"min_votes": 1}, [True]),
    ("second_origin_two_votes_withheld", [[0, 0, 0], [0, 14.0, 0]],
     _plate_map, [[12.0, 0, 0]], {"min_votes": 2}, [False]),
    ("two_clear_views_agree", [[0, 14.0, 0], [0, -14.0, 0]], _plate_map,
     [[12.0, 0, 0]], {"min_votes": 2}, [True]),
    ("min_dilation_is_conservative_at_holes", [[0, 0, 0]], _holed_wall,
     [[19.9, 0, 0]], {}, [False]),
]


@pytest.mark.parametrize("case", CASES, ids=[c[0] for c in CASES])
def test_analytic_cases_match(case):
    _, origins, make_map, queries, kw, want = case
    kw = dict(kw)
    kw.setdefault("margin_m", 0.4)
    kw.setdefault("max_judge_range", 22.0)
    pts = make_map()
    assert judge_jax(origins, pts, queries, **kw).tolist() == want
    assert judge_torch(origins, pts, queries, **kw).tolist() == want


def _bin_coords(d):
    """Float64 azimuth and elevation bin coordinates of directions d."""
    r = np.linalg.norm(d, axis=1)
    az = np.arctan2(d[:, 1], d[:, 0])
    el = np.arcsin(np.clip(d[:, 2] / np.maximum(r, 1e-6), -1, 1))
    return ((az + np.pi) / (2 * np.pi) * N_AZ, (el + EL) / (2 * EL) * N_EL,
            el)


def _off_edge(d, gap=1e-4):
    a, e, el = _bin_coords(d.astype(np.float64))
    fa, fe = a - np.floor(a), e - np.floor(e)
    return ((np.minimum(fa, 1 - fa) > gap) & (np.minimum(fe, 1 - fe) > gap)
            & (np.abs(np.abs(el) - EL) > 1e-4))


def _bins_both(d):
    r = np.linalg.norm(d, axis=1).astype(np.float32)
    jb, jf = jv._spherical_bins(jnp.asarray(d), jnp.asarray(r), N_AZ, N_EL,
                                -EL, EL)
    tb, tf = tv._spherical_bins(torch.as_tensor(d), torch.as_tensor(r),
                                N_AZ, N_EL, -EL, EL)
    return np.asarray(jb), np.asarray(jf), tb.numpy(), tf.numpy()


def _random_dirs(n, seed):
    rng = np.random.RandomState(seed)
    d = rng.randn(n, 3)
    d[:, 2] *= 0.4
    return (d * rng.uniform(1.0, 30.0, (n, 1))).astype(np.float32)


def test_spherical_bins_equal_off_the_edges():
    d = _random_dirs(200_000, 0)
    keep = _off_edge(d)
    assert keep.mean() > 0.99
    jb, jf, tb, tf = _bins_both(d[keep])
    np.testing.assert_array_equal(tb, jb)
    np.testing.assert_array_equal(tf, jf)


def test_spherical_bins_near_the_edges():
    d = _random_dirs(200_000, 1)
    jb, jf, tb, tf = _bins_both(d)
    diff = tb != jb
    assert diff.mean() <= 1e-3
    # one bin over in azimuth or in elevation (or across the azimuth wrap)
    da = np.abs((tb % N_AZ) - (jb % N_AZ))
    de = np.abs(tb // N_AZ - jb // N_AZ)
    assert (((da <= 1) | (da == N_AZ - 1)) & (de <= 1))[diff].all()


def test_render_matches_off_the_edges():
    rng = np.random.RandomState(2)
    pts = _random_dirs(2_000, 3) + rng.uniform(-1, 1, (1, 3)).astype(
        np.float32)
    origins = np.array([[0.0, 0.0, 0.0], [1.5, -2.0, 0.3]], np.float32)
    keep = np.all([_off_edge(pts - o) for o in origins], axis=0)
    pts = pts[keep]
    valid = rng.rand(len(pts)) < 0.9
    jimg = np.asarray(jv.render_min_range_bins(
        jnp.asarray(origins), jnp.asarray(pts), jnp.asarray(valid),
        n_az=N_AZ, n_el=N_EL, el_lo=-EL, el_hi=EL))
    timg = tv.render_min_range_bins(
        torch.as_tensor(origins), torch.as_tensor(pts),
        torch.as_tensor(valid), n_az=N_AZ, n_el=N_EL, el_lo=-EL,
        el_hi=EL).numpy()
    empty = jimg >= 3e38
    np.testing.assert_array_equal(timg >= 3e38, empty)
    assert 0 < empty.mean() < 0.9
    np.testing.assert_allclose(timg[~empty], jimg[~empty], rtol=1e-6)


def test_free_mask_matches():
    rng = np.random.RandomState(4)
    wall = ring_wall(n=30_000)
    origins = np.array([[0.0, 0.0, 0.0], [2.0, 1.0, 0.0], [-1.0, 3.0, 0.2]],
                       np.float32)
    q = (rng.randn(20_000, 3) * [9.0, 9.0, 0.8]).astype(np.float32)
    for votes in (1, 2, 3):
        kw = dict(min_votes=votes, margin_m=0.4, max_judge_range=22.0)
        j = judge_jax(origins, wall, q, **kw)
        t = judge_torch(origins, wall, q, **kw)
        assert j.any() and not j.all()
        np.testing.assert_array_equal(t, j)
