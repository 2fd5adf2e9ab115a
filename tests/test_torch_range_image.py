"""The port's scan incidence (pin_slam_tpu_torch.ops.range_image) and the
sampler's incidence modes against the JAX package on the JAX test's scans
(tests/test_range_image.py): a floor, a sensor-centred sphere, a floor with
masked and occluded rows, and a synthetic HDL-64 scan of the bench room.

Tolerance: the cosines agree to 1e-5 except on points that fall into
another bin, since atan2 and asin round differently in XLA and torch (as
in ops/visibility.py): at most 0.1 % of the points, against the JAX
function jitted, as the JAX system runs it, on the scans whose rays fall
at random azimuths, and against it as its own tests call it (eagerly) on
the floor, whose 256 rays sit exactly on the 256 azimuth bin edges (there
the jitted JAX function moves 314 of its 12288 points against its eager
self). The sampler, given the same noise and the same cosines,
agrees bit for bit in both modes with the JAX sampler called eagerly."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.models.sampler import sample_training_points as j_sample
from pin_slam_tpu.ops.range_image import estimate_scan_incidence as j_inc
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.models.sampler import (
    sample_training_points as t_sample)
from pin_slam_tpu_torch.ops.range_image import (
    estimate_scan_incidence as t_inc)

COS_ATOL = 1e-5
MAX_MOVED = 1e-3


def _lidar_floor(h=1.5, n_az=256, rings=24):
    az = np.linspace(-np.pi, np.pi, n_az, endpoint=False)
    el = np.linspace(np.radians(-70.0), np.radians(-12.0), rings)
    aa, ee = np.meshgrid(az, el)
    r = h / np.sin(-ee)
    pts = np.stack([r * np.cos(ee) * np.cos(aa),
                    r * np.cos(ee) * np.sin(aa),
                    -h * np.ones_like(aa)], -1).reshape(-1, 3)
    return pts.astype(np.float32)


def _sphere():
    rng = np.random.default_rng(0)
    az = rng.uniform(-np.pi, np.pi, 8192)
    el = rng.uniform(np.radians(-50), np.radians(50), 8192)
    return np.stack([10.0 * np.cos(el) * np.cos(az),
                     10.0 * np.cos(el) * np.sin(az),
                     10.0 * np.sin(el)], -1).astype(np.float32)


def _occluded():
    pts = _lidar_floor()
    pts[200:210] *= 3.0
    mask = np.ones(pts.shape[0], bool)
    mask[:100] = False
    return pts, mask


def _room_scan():
    s = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(2, radius=6.0, revolutions=0.03),
        dirs=lidar_directions(900, 64), max_range=60.0)
    pts = s.frame(1)[:, :3].astype(np.float32)
    return pts, np.ones(pts.shape[0], bool)


CASES = {
    "floor": lambda: (_lidar_floor(rings=48), None, dict(n_az=256, n_el=24,
                                                          cos_floor=0.02)),
    "sphere": lambda: (_sphere(), None, dict(n_az=128, n_el=32)),
    "occluded": lambda: (*_occluded(), dict(n_az=256, n_el=48,
                                             range_gate_m=0.5)),
    "room": lambda: (*_room_scan(), dict(n_az=512, n_el=64,
                                         range_gate_m=0.5, cos_floor=0.1)),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_incidence_matches_jax(case):
    pts, mask, kw = CASES[case]()
    if mask is None:
        mask = np.ones(pts.shape[0], bool)
    tc = t_inc(torch.as_tensor(pts), torch.as_tensor(mask), **kw).numpy()
    f = j_inc if case == "floor" else jax.jit(
        lambda p, m: j_inc(p, m, **kw))
    je = np.asarray(f(jnp.asarray(pts), jnp.asarray(mask), **(
        kw if case == "floor" else {})))
    assert tc.dtype == np.float32 and tc.shape == je.shape
    moved = np.abs(tc - je) > COS_ATOL
    assert moved.mean() <= MAX_MOVED, (case, moved.sum(), len(tc))
    if case == "occluded":
        # masked rows and occlusion edges keep cos = 1 (no correction)
        assert np.all(tc[:100] == 1.0) and np.all(tc[200:210] == 1.0)
    elif case != "sphere":
        # the scan exercises the correction, not only its fallback
        assert (je < 1.0).mean() > 0.3


@pytest.mark.parametrize("mode", ["label", "weight"])
def test_sampler_incidence_modes_match(mode):
    """The same noise (the JAX sampler's draws from its key) and the same
    cosines: labels, weights and points bit for bit; the surface band is
    never scaled."""
    pts = _lidar_floor()[:512]
    n = pts.shape[0]
    rng = np.random.RandomState(1)
    cos = rng.uniform(0.1, 1.0, n).astype(np.float32)
    mask = rng.rand(n) < 0.9
    kw = dict(surface_sample_range_m=0.3, surface_sample_n=3,
              free_front_n=2, free_behind_n=1, free_sample_begin_ratio=0.3,
              free_sample_end_dist_m=1.0, max_range=80.0,
              dist_weight_on=True, dist_weight_scale=0.8)
    key = jax.random.PRNGKey(4)
    js = j_sample(key, jnp.asarray(pts), jnp.asarray(mask),
                  cos_inc=jnp.asarray(cos), incidence_mode=mode, **kw)
    k_s, k_f, k_b = jax.random.split(key, 3)
    noise = tuple(torch.as_tensor(np.array(a)) for a in (
        jax.random.normal(k_s, (n, 3)), jax.random.uniform(k_f, (n, 2)),
        jax.random.uniform(k_b, (n, 1))))
    ts = t_sample(None, torch.as_tensor(pts), torch.as_tensor(mask),
                  noise=noise, cos_inc=torch.as_tensor(cos),
                  incidence_mode=mode, **kw)
    for f in ("points", "sdf_label", "weight", "mask"):
        np.testing.assert_array_equal(getattr(ts, f).numpy(),
                                      np.asarray(getattr(js, f)), err_msg=f)
    base = t_sample(None, torch.as_tensor(pts), torch.as_tensor(mask),
                    noise=noise, **kw)
    scaled = (ts.sdf_label if mode == "label" else ts.weight).reshape(n, 7)
    plain = (base.sdf_label if mode == "label" else base.weight).reshape(n, 7)
    assert torch.equal(scaled[:, :4], plain[:, :4])
    assert not torch.equal(scaled[:, 4:], plain[:, 4:])
