"""The port's sliding-window bundle adjustment (pin_slam_tpu_torch.slam.ba)
against the JAX package's, at a small size on the CPU.

* `collect_surface_samples`: the same rows in the same order, and the same
  count, exactly.
* The order-free feature gradient: the lset-less decode's feature gradient
  (`map_query.gather_rows_exact`) has the same bits whatever the order of
  the query rows, so of the repeated neighbour indices.
* `make_ba_loop` on a JAX system's state just before its second BA (window
  4 of 6 frames, so the first two poses stay fixed), carried into the port,
  with the JAX run's random draws fed in: poses and losses of three
  iterations to 1e-5, features to 1e-5 apart from the few whose gradient
  lies below Adam's eps (FEATURE_OUTLIERS).
* `run_bundle_adjustment` on the same carried state with the JAX draws, a
  whole BA of 10 iterations: the pose chain, the current pose, the map
  features and the replay pool against the JAX package's, at the bounds
  stated below (WHOLE_BA_*).
* A short BA run (the slice tests' small configuration, 6 frames, BA every
  3 frames: windows of 3 and 4 frames) of both packages from the same
  decoder, each with its own random draws:
  BA runs on the same frames, its loss falls, and every pose lies within
  MAX_DT / MAX_DA of the other package's and of ground truth.
"""

import copy

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import pin_slam_tpu.slam.ba as jba
from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.slam import ba as tba
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem
from tests.test_torch_slice import MAX_DA, MAX_DT, small_config

N = 6
BA_FRAMES = [2, 5]
# Adam's step is about lr * g / (|g| + eps), eps = 1e-15: a feature whose
# gradient is below ~1e-15 moves in proportion to it, so to the float
# rounding of the query coordinates (XLA and torch sum the re-projection
# in another order; 2e-6 m here). About 1.3 % of the moved features
# (gradients of 1e-17..1e-15) step differently in the first iterations.
FEATURE_OUTLIERS = 0.03
# a whole BA (10 iterations): pose entries (BA moves them by ~1e-3 here;
# the packages differ by ~4e-6), pool coordinates up to 40 m out (differ
# by ~1e-4 m), and the share of the moved features that differ by more
# than 1e-3 (0.35-0.5 % measured)
WHOLE_BA_POSE_ATOL = 5e-5
WHOLE_BA_POOL_ATOL = 5e-4
WHOLE_BA_FEATURE_OUTLIERS = 0.02
HOST = ("odom_poses", "pgo_poses", "travel_dist", "reboot_ts",
        "cur_pose_ref", "last_pose_ref")


@pytest.fixture(scope="module", autouse=True)
def one_thread():
    """Torch on one thread: the test workers share the machine's cores."""
    old = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(old)


def ba_config(cls):
    cfg = small_config(cls)
    cfg.ba_freq_frame = 3
    cfg.ba_frame = 4
    cfg.ba_iters = 10
    cfg.ba_bs = 1024
    return cfg


def _np_tree(t):
    return jax.tree.map(np.asarray, t)


@pytest.fixture(scope="module")
def scenario():
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    return seq, [seq.frame(i) for i in range(N)]


@pytest.fixture(scope="module")
def jax_run(scenario):
    """The JAX system over the frames; each BA call keeps what it read and
    what it wrote."""
    seq, frames = scenario
    js = JSystem(ba_config(JConfig))
    js.set_gt_poses(seq.poses)
    calls, real = [], jba.run_bundle_adjustment

    def keep(system, frame_id):
        before = dict(
            fid=frame_id, key=np.asarray(system.key),
            state={f: np.asarray(getattr(system.state, f))
                   for f in convert.STATE_FIELDS},
            pool={f: np.asarray(getattr(system.pool, f))
                  for f in convert.POOL_FIELDS},
            geo_mlp=_np_tree(system.params["geo_mlp"]),
            host={k: copy.deepcopy(getattr(system, k)) for k in HOST})
        loss = real(system, frame_id)
        calls.append(dict(before=before, loss=loss, after=dict(
            feats=np.asarray(system.params["geo_features"]),
            coord=np.asarray(system.pool.coord),
            host={k: copy.deepcopy(getattr(system, k)) for k in HOST})))
        return loss

    init_mlp = _np_tree(js.params["geo_mlp"])
    jba.run_bundle_adjustment = keep
    try:
        poses = [js.process_frame(i, frames[i]) for i in range(N)]
    finally:
        jba.run_bundle_adjustment = real
    return dict(system=js, calls=calls, poses=poses, init_mlp=init_mlp)


def _jax_draws(key, pool_np, n_iters, bs):
    """The picks of JAX's BA loop, from its key schedule."""
    _, scount = jba.collect_surface_samples(_jax_pool(pool_np), 1 << 18)
    keys = jax.random.split(key, n_iters)
    hi = max(int(scount), 1)
    return torch.stack([torch.as_tensor(np.asarray(
        jax.random.randint(k, (bs,), 0, hi))).long() for k in keys])


def _jax_pool(pool_np):
    from pin_slam_tpu.slam.mapper import PoolState as JPool
    return JPool(**{f: jnp.asarray(pool_np[f]) for f in convert.POOL_FIELDS},
                 sem_label=None, color_label=None)


def _carry(before):
    """A port system holding the JAX system's state at a BA call."""
    ts = TSystem(ba_config(TConfig), device="cpu")
    ts.state = convert.state_from_numpy(before["state"], device="cpu")
    ts.pool = convert.pool_from_numpy(before["pool"], device="cpu")
    ts.params = {"geo_features": ts.state.geo_features,
                 "geo_mlp": convert.mlp_from_numpy(before["geo_mlp"],
                                                   device="cpu")}
    for k, v in before["host"].items():
        setattr(ts, k, copy.deepcopy(v))
    return ts


@pytest.mark.parametrize("cap", [40, 5000])
def test_collect_surface_samples(cap):
    rng = np.random.RandomState(0)
    P = 3000
    label = rng.randn(P + 1).astype(np.float32)
    label[rng.rand(P + 1) < 0.3] = 0.0
    pool_np = dict(coord=rng.randn(P + 1, 3).astype(np.float32),
                   sdf_label=label, weight=np.ones(P + 1, np.float32),
                   ts=np.zeros(P + 1, np.int32), count=np.int32(2500),
                   new_idx=np.zeros(9, np.int32), new_count=np.int32(0),
                   write_pos=np.int32(2500))
    jidx, jn = jba.collect_surface_samples(_jax_pool(pool_np), cap)
    tidx, tn = tba.collect_surface_samples(
        convert.pool_from_numpy(pool_np, device="cpu"), cap)
    assert int(tn) == int(jn) == min(cap, int((label[:2500] == 0).sum()))
    np.testing.assert_array_equal(tidx.numpy(), np.asarray(jidx))


def test_feature_gradient_is_order_free():
    """The lset-less decode's feature gradient is the same bits whatever
    the order of the query rows: the repeated neighbour indices' sums are
    order-free. (A float index_add in another order changes last bits.)"""
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.models.decoder import init_mlp_params

    rng = np.random.RandomState(3)
    cfg = ba_config(TConfig)
    qp = tmq.make_query_params(cfg)
    state = npm.init_map_state(1 << 12, 1 << 14, cfg.feature_dim,
                               device="cpu")
    pts = torch.as_tensor(rng.uniform(-2, 2, (3000, 3)).astype(np.float32))
    state, _ = npm.insert_points(
        state, pts, torch.ones(3000, dtype=torch.bool), 0,
        torch.zeros(cfg.max_frames), resolution=cfg.voxel_size_m,
        local_window_dist=1e9, force_all_new=True, insert_cap=1 << 12)
    feats = torch.as_tensor(rng.randn(state.capacity + 1, cfg.feature_dim)
                            .astype(np.float32)) * 0.3
    mlp = init_mlp_params(torch.Generator().manual_seed(0),
                          cfg.feature_dim + 3, 16, 1, 1, True, device="cpu")
    q = torch.as_tensor(rng.uniform(-1.5, 1.5, (4000, 3)).astype(np.float32))
    grads = []
    for seed in range(3):
        perm = torch.as_tensor(np.random.RandomState(seed).permutation(4000))
        f = feats.clone().requires_grad_(True)
        out = tmq.query_decode(f, mlp, q[perm], qp, state=state)
        (out.sdf ** 2).sum().backward()
        grads.append(f.grad)
    assert (grads[0] != 0).sum() > 1000
    for g in grads[1:]:
        assert torch.equal(g, grads[0])


def test_ba_loop_with_fed_draws(jax_run):
    """Three iterations of the second BA (frame 5, window 4) from the JAX
    state with JAX's draws: poses, features and losses to 1e-5."""
    js, call = jax_run["system"], jax_run["calls"][1]
    b = call["before"]
    fid, n_iters = b["fid"], 3
    c = js.config
    n = fid + 1
    window = min(c.ba_frame, n)
    base = b["host"]["odom_poses"][:n]
    base_full = np.tile(np.eye(4), (c.max_frames, 1, 1))
    base_full[:n] = base
    key = jax.random.PRNGKey(5)
    jloop = jba.make_ba_loop(js.qp, n_iters=n_iters, bs=c.ba_bs,
                             window=window, lr_pose=c.lr_pose,
                             lr_map=c.lr_ba_map, adam_eps=c.adam_eps)
    jstate = js.state.replace(**{f: jnp.asarray(b["state"][f])
                                 for f in convert.STATE_FIELDS})
    jposes, jfeats, jlosses = jloop(
        jstate, _jax_pool(b["pool"]), jnp.asarray(b["state"]["geo_features"]),
        jax.tree.map(jnp.asarray, b["geo_mlp"]),
        jnp.asarray(base_full, jnp.float32), jnp.int32(n - window), key,
        js._lf(fid))

    ts = _carry(b)
    tloop = tba.make_ba_loop(ts.qp, n_iters=n_iters, bs=c.ba_bs,
                             window=window, lr_pose=c.lr_pose,
                             lr_map=c.lr_ba_map, adam_eps=c.adam_eps)
    draws = _jax_draws(key, b["pool"], n_iters, c.ba_bs)
    tposes, tfeats, tlosses = tloop(
        ts.state, ts.pool, ts.params["geo_features"], ts.params["geo_mlp"],
        ts._tensor(base), n - window, None, ts._lf(fid), draws=draws)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               atol=1e-5)
    np.testing.assert_allclose(tposes.numpy(), np.asarray(jposes)[:n],
                               atol=1e-5)
    np.testing.assert_array_equal(tposes.numpy()[: n - window],
                                  base[: n - window].astype(np.float32))
    _check_features(tfeats.numpy(), np.asarray(jfeats),
                    b["state"]["geo_features"], 1e-5, c.lr_ba_map * n_iters,
                    FEATURE_OUTLIERS)


def _check_features(got, want, before, tol, max_step, outliers):
    """Features against the JAX package's: at most `outliers` of the moved
    elements differ by more than `tol`, none by more than twice the most
    Adam can move one (lr per iteration)."""
    moved = want != before
    df = np.abs(got - want)
    assert moved.sum() > 1000
    assert (df[moved] > tol).mean() <= outliers, (df > tol).sum()
    assert np.median(df[moved]) <= 1e-5
    assert df.max() <= 2 * max_step


@pytest.mark.parametrize("call_i", [0, 1])
def test_run_bundle_adjustment(jax_run, call_i):
    """A whole BA (10 iterations) of the JAX run, redone by the port from
    the carried state with the JAX draws."""
    call = jax_run["calls"][call_i]
    b, a = call["before"], call["after"]
    fid = b["fid"]
    n = fid + 1
    c = jax_run["system"].config
    k = jax.random.split(jnp.asarray(b["key"]))[1]
    ts = _carry(b)
    loss = tba.run_bundle_adjustment(
        ts, fid, draws=_jax_draws(k, b["pool"], c.ba_iters, c.ba_bs))
    losses = ts.last_ba_losses.numpy()
    assert losses[-1] < losses[0]
    assert abs(loss - call["loss"]) <= 1e-5
    np.testing.assert_allclose(ts.odom_poses[:n], a["host"]["odom_poses"][:n],
                               atol=WHOLE_BA_POSE_ATOL)
    np.testing.assert_allclose(ts.cur_pose_ref, a["host"]["cur_pose_ref"],
                               atol=WHOLE_BA_POSE_ATOL)
    moved = np.abs(ts.odom_poses[:n] - b["host"]["odom_poses"][:n]).max()
    assert moved > 10 * WHOLE_BA_POSE_ATOL
    np.testing.assert_allclose(ts.pool.coord.numpy(), a["coord"],
                               atol=WHOLE_BA_POOL_ATOL)
    _check_features(ts.params["geo_features"].numpy(), a["feats"],
                    b["state"]["geo_features"], 1e-3, c.lr_ba_map * c.ba_iters,
                    WHOLE_BA_FEATURE_OUTLIERS)
    assert ts.state.geo_features is ts.params["geo_features"]


@pytest.fixture(scope="module")
def torch_run(scenario, jax_run):
    seq, frames = scenario
    ts = TSystem(ba_config(TConfig), device="cpu")
    ts.params["geo_mlp"] = convert.mlp_from_numpy(jax_run["init_mlp"],
                                                  device="cpu")
    ts.set_gt_poses(seq.poses)
    ba_at, curves, poses = [], [], []
    for i in range(N):
        before = ts.last_ba_losses
        poses.append(ts.process_frame(i, frames[i]))
        if ts.last_ba_losses is not before:
            ba_at.append(i)
            curves.append(ts.last_ba_losses.numpy())
    return dict(poses=poses, ba_at=ba_at, curves=curves, system=ts)


def _err(a, b):
    dt = np.linalg.norm(a[:3, 3] - b[:3, 3])
    R = a[:3, :3].T @ b[:3, :3]
    da = np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))
    return dt, da


def test_short_run_bundle_adjusts_the_same_frames(jax_run, torch_run):
    assert [cl["before"]["fid"] for cl in jax_run["calls"]] == BA_FRAMES
    assert torch_run["ba_at"] == BA_FRAMES
    for curve in torch_run["curves"]:
        assert np.isfinite(curve).all() and curve[-1] < curve[0]


@pytest.mark.parametrize("frame", range(1, N))
def test_short_run_poses(scenario, jax_run, torch_run, frame):
    seq, _ = scenario
    t, j = torch_run["poses"][frame], jax_run["poses"][frame]
    for other in (j, seq.poses[frame]):
        dt, da = _err(t, other)
        assert dt < MAX_DT and da < MAX_DA, (frame, dt, da)
    dt, da = _err(j, seq.poses[frame])
    assert dt < MAX_DT and da < MAX_DA, ("jax", frame, dt, da)
