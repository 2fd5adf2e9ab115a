"""The port's map-based dynamic filter (PinSLAMSystem.dynamic_filter, with
the visibility test of ops/visibility.py) against the JAX package's, at a
small size on the CPU.

Scene: the default room plus three spheres of 0.8 m crossing it at 0.15 m
a frame (`moving_spheres_scene`); 6 frames of a circle, historic origins 2
and 4 frames back; the slice tests' small configuration.

* The filter on a carried state: the JAX system's map, decoder and inputs
  of its filter at the last frame, carried into the port. The static masks
  agree on every row whose SDF and certainty lie more than 1e-4 from a
  threshold of the filter, and on all but 0.1 % of the rows overall (a
  point within float rounding of a visibility bin edge lands one bin over,
  see tests/test_torch_visibility.py). With the visibility test off, the
  certainty-and-SDF filter alone agrees on every row off the thresholds.
* The same state through the per-neighbour decode (`weighted_first=False`,
  the route of the fused decode kernel, whose plain version runs on the
  CPU) against the JAX package's decode of the same map: SDF to 1e-5,
  certainty to float32 rounding (1e-6 relative).
* A short run of both packages from the same decoder, each with its own
  random draws: the filter judges the same frames, flags measurements of
  the movers and few static ones (MAX_FALSE_DYNAMIC*), and every pose lies
  within MAX_DT / MAX_DA of the other package's and of ground truth.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions,
    moving_spheres_scene)
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem
from tests.test_torch_slice import MAX_DA, MAX_DT, small_config

N = 6
MOVER_RADIUS = 0.8
# the JAX package's bound on static measurements flagged dynamic
# (tests/test_visibility.py, a static scene from frame 6 on), held at the
# last frame; the young map of the first frames is looser in both packages
# (the JAX package flags 1.0-1.8 % of the static measurements in frames
# 1-4 of this run), so there the bound is 2 %
MAX_FALSE_DYNAMIC = 0.01
MAX_FALSE_DYNAMIC_YOUNG = 0.02
# rows whose SDF or certainty lie this close to a threshold may flip
NEAR_THRESHOLD = 1e-4
HOST = ("odom_poses", "pgo_poses", "travel_dist", "reboot_ts")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def dyn_config(cls, weighted_first=True, visibility=True):
    cfg = small_config(cls)
    cfg.weighted_first = weighted_first
    cfg.dynamic_filter_on = True
    cfg.visibility_filter_on = visibility
    cfg.visibility_hist_offsets = (2, 4)
    return cfg


@pytest.fixture(scope="module")
def scenario():
    static = default_scene()
    scene_t, centers = moving_spheres_scene(static, N, radius=MOVER_RADIUS)
    seq = SyntheticSequence(
        scene_sdf=static, scene_sdf_t=scene_t,
        poses=circle_trajectory(N, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    return seq, [seq.frame(i) for i in range(N)], centers


def _mover_truth(train_pts, n, pose, centers_f):
    """Training points within radius + 0.1 m of a mover's centre."""
    w = train_pts[:n] @ pose[:3, :3].T + pose[:3, 3]
    d = np.linalg.norm(w[:, None, :] - centers_f[None], axis=-1)
    return (d < MOVER_RADIUS + 0.1).any(1)


def _score(system, fid, seq, centers, pose):
    n = int(system.last_train_n)
    static = np.asarray(system.last_static_mask)[:n]
    mover = _mover_truth(np.asarray(system.last_train_pts), n, pose,
                         centers[fid])
    return dict(fid=fid, n=n, movers=int(mover.sum()),
                flagged_movers=int((~static & mover).sum()),
                false_dynamic=float((~static & ~mover).sum()
                                    / max((~mover).sum(), 1)))


@pytest.fixture(scope="module")
def jax_run(scenario):
    """The JAX system over the frames; the filter's inputs and verdict at
    the last frame are kept."""
    seq, frames, centers = scenario
    js = JSystem(dyn_config(JConfig))
    js.set_gt_poses(seq.poses)
    real, rec = js._dynamic_filter, {}

    def keep(state, feats, mlp, world, mask, lf, hist):
        out = real(state, feats, mlp, world, mask, lf, hist)
        rec.update(
            state={f: np.asarray(feats if f == "geo_features"
                                 else getattr(state, f))
                   for f in convert.STATE_FIELDS},
            geo_mlp=jax.tree.map(np.asarray, mlp),
            world=np.asarray(world), mask=np.asarray(mask),
            hist=np.asarray(hist), static=np.asarray(out),
            host={k: copy.deepcopy(getattr(js, k)) for k in HOST})
        return out

    init_mlp = jax.tree.map(np.asarray, js.params["geo_mlp"])
    js._dynamic_filter = keep
    poses, scores = [], []
    for i in range(N):
        poses.append(js.process_frame(i, frames[i]))
        if i > 0:
            scores.append(_score(js, i, seq, centers, poses[-1]))
    return dict(system=js, rec=rec, poses=poses, scores=scores,
                init_mlp=init_mlp)


def _carry(rec, **kw):
    ts = TSystem(dyn_config(TConfig, **kw), device="cpu")
    ts.state = convert.state_from_numpy(rec["state"], device="cpu")
    ts.params = {"geo_features": ts.state.geo_features,
                 "geo_mlp": convert.mlp_from_numpy(rec["geo_mlp"],
                                                   device="cpu")}
    for k, v in rec["host"].items():
        setattr(ts, k, copy.deepcopy(v))
    return ts


def _near_threshold(out, cfg):
    """Rows whose decoded SDF or certainty lie within NEAR_THRESHOLD of one
    of the filter's thresholds."""
    sdf, cert = np.asarray(out.sdf), np.asarray(out.certainty)
    v = cfg.voxel_size_m
    near = np.abs(cert - cfg.dynamic_certainty_thre) < NEAR_THRESHOLD
    for t in (cfg.dynamic_sdf_ratio_thre * v, 1.5 * v, -1.5 * v):
        near |= np.abs(sdf - t) < NEAR_THRESHOLD
    return near


def _jax_decode(js, rec, fid):
    from pin_slam_tpu.slam import map_query as jmq
    state = js.state.replace(**{f: jnp.asarray(rec["state"][f])
                                for f in convert.STATE_FIELDS})
    return jmq.query_decode(state, state.geo_features,
                            jax.tree.map(jnp.asarray, rec["geo_mlp"]),
                            jnp.asarray(rec["world"]), js.qp,
                            lf=js._lf(fid - 1))


@pytest.mark.parametrize("visibility", [True, False])
def test_filter_on_carried_state(jax_run, visibility):
    js, rec = jax_run["system"], jax_run["rec"]
    fid = N - 1
    ts = _carry(rec, visibility=visibility)
    got = ts.dynamic_filter(
        torch.as_tensor(rec["world"]), torch.as_tensor(rec["mask"]),
        ts._lf(fid - 1), torch.as_tensor(rec["hist"])).numpy()
    want = rec["static"] if visibility else _jax_filter(js, rec, fid)
    near = _near_threshold(_jax_decode(js, rec, fid), ts.config)
    diff = got != want
    n = int(rec["mask"].sum())
    assert (~want[:n]).sum() > 20
    assert diff.sum() <= 0.001 * n, diff.sum()
    if not visibility:
        assert not (diff & ~near).any()


def _jax_filter(js, rec, fid):
    """The JAX package's filter without the visibility test (its
    certainty-and-SDF rule) on the recorded inputs."""
    c = js.config
    out = _jax_decode(js, rec, fid)
    static = (out.certainty < c.dynamic_certainty_thre) | (
        out.sdf < c.dynamic_sdf_ratio_thre * c.voxel_size_m)
    return np.asarray(jnp.asarray(rec["mask"]) & static)


def test_per_neighbour_decode_on_carried_state(jax_run):
    """weighted_first=False: the filter's SDF and certainty through the
    route of the fused decode kernel against the JAX package's
    per-neighbour decode of the same map, to 1e-5."""
    from pin_slam_tpu.slam import map_query as jmq
    from pin_slam_tpu_torch.slam import map_query as tmq

    js, rec = jax_run["system"], jax_run["rec"]
    fid = N - 1
    ts = _carry(rec, weighted_first=False)
    jqp = js.qp._replace(weighted_first=False)
    state = js.state.replace(**{f: jnp.asarray(rec["state"][f])
                                for f in convert.STATE_FIELDS})
    jo = jmq.query_decode(state, state.geo_features,
                          jax.tree.map(jnp.asarray, rec["geo_mlp"]),
                          jnp.asarray(rec["world"]), jqp, lf=js._lf(fid - 1))
    to = tmq.query_decode(ts.params["geo_features"], ts.params["geo_mlp"],
                          torch.as_tensor(rec["world"]), ts.qp,
                          state=ts.state, lf=ts._lf(fid - 1), fused=True)
    seen = np.asarray(jo.nn_count) > 0
    assert seen.mean() > 0.5
    np.testing.assert_allclose(to.sdf.numpy(), np.asarray(jo.sdf), atol=1e-5)
    # certainties are weighted sums of values up to ~50: float32 rounding
    np.testing.assert_allclose(to.certainty.numpy(),
                               np.asarray(jo.certainty), rtol=1e-6,
                               atol=1e-6)


@pytest.fixture(scope="module")
def torch_run(scenario, jax_run):
    seq, frames, centers = scenario
    ts = TSystem(dyn_config(TConfig), device="cpu")
    ts.params["geo_mlp"] = convert.mlp_from_numpy(jax_run["init_mlp"],
                                                  device="cpu")
    ts.set_gt_poses(seq.poses)
    poses, scores = [], []
    for i in range(N):
        poses.append(ts.process_frame(i, frames[i]))
        if i > 0:
            scores.append(_score(ts, i, seq, centers, poses[-1]))
    return dict(poses=poses, scores=scores, system=ts)


def test_short_run_filter_scores(jax_run, torch_run):
    for run in (jax_run, torch_run):
        scores = run["scores"]
        assert [s["fid"] for s in scores] == list(range(1, N))
        assert sum(s["movers"] for s in scores) > 50
        assert sum(s["flagged_movers"] for s in scores) > 0
        assert max(s["false_dynamic"] for s in scores) \
            <= MAX_FALSE_DYNAMIC_YOUNG
        assert scores[-1]["false_dynamic"] <= MAX_FALSE_DYNAMIC


def _err(a, b):
    dt = np.linalg.norm(a[:3, 3] - b[:3, 3])
    R = a[:3, :3].T @ b[:3, :3]
    da = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    return dt, da


@pytest.mark.parametrize("frame", range(1, N))
def test_short_run_poses(scenario, jax_run, torch_run, frame):
    seq = scenario[0]
    t, j = torch_run["poses"][frame], jax_run["poses"][frame]
    for other in (j, seq.poses[frame]):
        dt, da = _err(t, other)
        assert dt < MAX_DT and da < MAX_DA, (frame, dt, da)
    dt, da = _err(j, seq.poses[frame])
    assert dt < MAX_DT and da < MAX_DA, ("jax", frame, dt, da)
