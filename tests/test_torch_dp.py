"""The port's data parallelism (parallel/dp.py, `make_train_loop(mesh=)`,
`Mesher(mesh=)`, `PinSLAMSystem` with `dp_on`) against the JAX package's
shard_map loop and sharded mesher on 8 replicas on the CPU (the 8 virtual
CPU devices tests/conftest.py gives JAX; `["cpu"] * 8` in the port), on
tests/test_parallel.py's sphere setup.

* The training loop, both on the whole-map route (cells) and on the
  join route's subset path: replica r's draws are the JAX keys folded with
  r. Losses, trained features and decoder to rtol 1e-4 / atol 1e-5 (float
  sums over replicas round in another order; Adam is optax's in torch),
  certainty to 1e-4 (on the join route to 8 float32 ulps of the total
  certainty added, where that is larger: the JAX route's sorted running
  sum, as tests/test_torch_mapper.py states), update timestamps equal.
* The sharded mesher equals the port's unsharded grid bit for bit and the
  JAX package's sharded grid to rtol 1e-5 / atol 1e-6, nn_count equal, at
  the grid points off the map's voxel faces (on a face jitted XLA's
  `p * (1 / res)` may floor into the other cell, ROADMAP.md section 3).
* A `dp_on` system with 8 CPU replicas runs 3 synthetic frames beside the
  JAX package's (test_torch_probe_modes.py's small configuration under the
  cell probe, the JAX package's choice on the CPU), its poses within that
  file's bounds of the JAX system's and of ground truth.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jnpm
from pin_slam_tpu.models.decoder import init_mlp_params as j_init_mlp
from pin_slam_tpu.ops import knn_join as jk
from pin_slam_tpu.parallel import dp as jdp
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu.slam import mapper as jmp
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.parallel import dp as tdp
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam import mapper as tmp

jax.config.update("jax_default_matmul_precision", "highest")
NDEV = 8
N_ITERS = 3
BS = 512
LOSS_KW = dict(sigma_sigmoid_m=0.1, loss_weight_on=False,
               ekional_loss_on=True, weight_e=0.5, numerical_grad_eps=0.06,
               gradient_decimation=10, surface_sample_range_m=0.25)
MAX_DT, MAX_DA = 0.10, 0.5           # test_torch_slice.py's
LATE_DT, LATE_DA = 0.15, 5.0         # test_torch_probe_modes.py's frame 2


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfg(cls, probe_mode):
    c = cls()
    c.voxel_size_m = 0.3
    c.probe_mode = probe_mode
    return c.finalize()


@pytest.fixture(scope="module")
def sphere():
    """tests/test_parallel.py's sphere setup: a map of 3000 points on a 5 m
    sphere, a pool of 8192 samples around it, a decoder from PRNGKey(7)."""
    rng = np.random.RandomState(0)
    d = rng.randn(3000, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    pts = (d * 5.0).astype(np.float32)
    state = jnpm.init_map_state(1 << 13, 1 << 15, 8, False)
    td = jnp.zeros(16, jnp.float32)
    state, _ = jnpm.insert_points(
        state, jnp.asarray(pts), jnp.ones(len(pts), bool), 0, td,
        resolution=0.3, local_window_dist=100.0)
    pool = jmp.init_pool(20_000, 1 << 10, False, 0)
    sp = pts[rng.randint(0, len(pts), 8192)] \
        + rng.randn(8192, 3).astype(np.float32) * 0.15
    sdf = np.linalg.norm(sp, axis=1) - 5.0
    pool = jmp.append_samples(
        pool, jnp.asarray(sp), jnp.asarray(sdf.astype(np.float32)),
        jnp.ones(8192), jnp.ones(8192, bool), 0)
    mlp = j_init_mlp(jax.random.PRNGKey(7), 8 + 3, 64, 1, 1)
    return dict(state=state, pool=pool, mlp=mlp, td=td)


def _port(s):
    """The sphere setup as the port's state, params, pool and filter."""
    params, state = convert.from_jax(
        {"geo_mlp": jax.tree.map(np.asarray, s["mlp"])},
        {f: np.asarray(getattr(s["state"], f))
         for f in convert.STATE_FIELDS}, device="cpu")
    pool = convert.pool_from_numpy(
        {f: np.asarray(getattr(s["pool"], f)) for f in convert.POOL_FIELDS},
        device="cpu")
    lf = tmq.LocalFilter(travel_dist=torch.zeros(16), cur_ts=0,
                         local_window_dist=100.0)
    return params, state, pool, lf


def _whole_map_draws(key, count):
    """Replica r's draws of the JAX DP loop's whole-map run: each
    iteration's batch key folded with r (`draw_batch_indices`, bs_new 0)."""
    out = []
    keys = jax.random.split(key, N_ITERS + 1)[1:]
    for r in range(NDEV):
        hist = []
        for k in keys:
            kb, _ = jax.random.split(k)
            k1, _ = jax.random.split(jax.random.fold_in(kb, r))
            hist.append(jax.random.randint(k1, (BS,), 0, count))
        out.append({"hist": _t(jnp.stack(hist)).long(),
                    "new_sel": torch.zeros((N_ITERS, 0), dtype=torch.long)})
    return out


def _subset_draws(key, count, subset_hist):
    """Replica r's draws of the JAX DP loop's subset run (bs_new 0): the
    history subset from keys[1] folded with r."""
    keys = jax.random.split(key, N_ITERS + 2)
    S_h = max(BS, min(subset_hist, N_ITERS * BS))
    return [{"hist": _t(jax.random.randint(
        jax.random.fold_in(keys[1], r), (S_h,), 0, count)).long(),
        "new_sel": torch.zeros((N_ITERS, 0), dtype=torch.long)}
        for r in range(NDEV)]


def _compare(jp, jst, jlosses, tp, tst, tlosses, cert_atol=1e-4):
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-4, atol=1e-5)
    # the JAX whole-map loop returns the trained features in its params
    np.testing.assert_allclose(tst.geo_features.numpy(),
                               np.asarray(jp["geo_features"]),
                               rtol=1e-4, atol=1e-5)
    for a, b in zip(tp["geo_mlp"]["w"] + tp["geo_mlp"]["b"],
                    jp["geo_mlp"]["w"] + jp["geo_mlp"]["b"]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-4,
                                   atol=1e-5)
    np.testing.assert_allclose(tst.certainty.numpy(),
                               np.asarray(jst.certainty), rtol=1e-4,
                               atol=cert_atol)
    np.testing.assert_array_equal(tst.ts_update.numpy(),
                                  np.asarray(jst.ts_update))


def test_make_mesh():
    assert tdp.make_mesh(devices=["cpu"] * 3) == [torch.device("cpu")] * 3
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdp.make_mesh()


def test_dp_loop_whole_map_matches_jax(sphere):
    s = sphere
    lr, eps = JConfig().lr, JConfig().adam_eps
    opt = optax.adam(lr, eps=eps)
    jloop = jmp.make_train_loop(
        jmq.make_query_params(_cfg(JConfig, "cells")), opt, n_iters=N_ITERS,
        bs=BS, bs_new=0, train_decoder=True, loss_kwargs=LOSS_KW,
        mesh=jdp.make_mesh(NDEV))
    key = jax.random.PRNGKey(11)
    jparams = {"geo_features": s["state"].geo_features, "geo_mlp": s["mlp"]}
    jlf = jmq.LocalFilter(travel_dist=s["td"], cur_ts=jnp.int32(0),
                          local_window_dist=100.0)
    jp, _, jst, _, jlosses = jloop(jparams, opt.init(jparams), s["state"],
                                   s["pool"], key, jlf, jnp.bool_(False),
                                   None)
    tparams, tst, tpool, tlf = _port(s)
    tloop = tmp.make_train_loop(
        tmq.make_query_params(_cfg(TConfig, "cells")), lr=lr, adam_eps=eps,
        n_iters=N_ITERS, bs=BS, bs_new=0, train_decoder=True,
        loss_kwargs=LOSS_KW, mesh=tdp.make_mesh(devices=["cpu"] * NDEV))
    tp, tst, tlosses = tloop(
        tparams, tst, tpool, None, torch.tensor(False), None,
        draws=_whole_map_draws(key, int(s["pool"].count)), lf=tlf)
    _compare(jp, jst, jlosses, tp, tst, tlosses)


def test_dp_loop_join_subset_matches_jax(sphere):
    """The join route's subset path: each replica draws its own history
    subset, probes it once against the (replicated) local set and trains
    on rotating windows of it; the certainty of every replica's subset
    rows reaches the set's rows."""
    s = sphere
    lr, eps = JConfig().lr, JConfig().adam_eps
    opt = optax.adam(lr, eps=eps)
    jqp = jmq.make_query_params(_cfg(JConfig, "join"))
    jloop = jmp.make_train_loop(
        jqp, opt, n_iters=N_ITERS, bs=BS, bs_new=0, train_decoder=True,
        loss_kwargs=LOSS_KW, mesh=jdp.make_mesh(NDEV), subset_hist=2048)
    st = s["state"]
    m = jnp.arange(st.capacity) < st.count
    jls = jk.build_local_set(st.positions, m, 0.3, 4096,
                             certainty=st.certainty, ts_update=st.ts_update)
    key = jax.random.PRNGKey(5)
    jparams = {"geo_features": st.geo_features, "geo_mlp": s["mlp"]}
    jp, _, jst, _, jlosses = jloop(jparams, opt.init(jparams), st,
                                   s["pool"], key, None, jnp.bool_(False),
                                   jls)
    tparams, tst, tpool, _ = _port(s)
    tls = convert.lset_from_numpy(
        {k: np.asarray(v) for k, v in jls._asdict().items()
         if v is not None}, device="cpu")
    tloop = tmp.make_train_loop(
        tmq.make_query_params(_cfg(TConfig, "join")), lr=lr, adam_eps=eps,
        n_iters=N_ITERS, bs=BS, bs_new=0, train_decoder=True,
        loss_kwargs=LOSS_KW, subset_hist=2048,
        mesh=tdp.make_mesh(devices=["cpu"] * NDEV))
    tp, tst, tlosses = tloop(
        tparams, tst, tpool, None, torch.tensor(False), tls,
        draws=_subset_draws(key, int(s["pool"].count), 2048))
    # the JAX join route takes each row's certainty sum as the difference
    # of a float32 running sum over all contributions (its sorted segment
    # sum), so its absolute error grows with the total added: a few float32
    # ulps of that total (test_torch_mapper.py's bound), above 1e-4 here
    total = float(np.sum(jst.certainty) - np.sum(st.certainty))
    _compare(jp, jst, jlosses, tp, tst, tlosses,
             cert_atol=max(1e-4, 8 * 2.0 ** -24 * total))


def test_sharded_mesher_matches(sphere):
    """TestShardedMesher's grid: the port's sharded grid equals its
    unsharded grid bit for bit and the JAX package's sharded grid to rtol
    1e-5 / atol 1e-6 with equal nn_count; the sharded map mesh equals the
    unsharded one."""
    from pin_slam_tpu.slam.mesher import MeshConfig as JMC
    from pin_slam_tpu.slam.mesher import Mesher as JMesher
    from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher

    s = sphere
    origin, dims = np.array([-6.5, -6.5, -6.5]), (27, 27, 27)
    jm = JMesher(jmq.make_query_params(_cfg(JConfig, "cells")),
                 JMC(mc_res_m=0.5, infer_bs=1 << 12, mesh_min_nn=1),
                 mesh=jdp.make_mesh(NDEV))
    sdf_j, nn_j = jm.query_sdf_grid(s["state"], s["state"].geo_features,
                                    s["mlp"], origin, dims)
    tparams, tst, _, _ = _port(s)
    tqp = tmq.make_query_params(_cfg(TConfig, "cells"))
    mc = MeshConfig(mc_res_m=0.5, infer_bs=1 << 12, mesh_min_nn=1,
                    min_cluster_vertices=0)
    plain = Mesher(tqp, mc)
    sharded = Mesher(tqp, mc, mesh=tdp.make_mesh(devices=["cpu"] * NDEV))
    args = (tst, tparams["geo_features"], tparams["geo_mlp"])
    sdf_a, nn_a = plain.query_sdf_grid(*args, origin, dims)
    sdf_b, nn_b = sharded.query_sdf_grid(*args, origin, dims)
    np.testing.assert_array_equal(sdf_a, sdf_b)
    np.testing.assert_array_equal(nn_a, nn_b)
    # jitted XLA floors p * (1 / res) where the port (as eager JAX) divides
    # (ROADMAP.md section 3): on this grid 70 % of the points lie on a
    # voxel face of the 0.3 m map, and there the cell a point falls in may
    # differ; everywhere else the grids agree
    X, Y, Z = dims
    i = np.arange(X * Y * Z)
    q = (np.stack([i // (Y * Z), (i // Z) % Y, i % Z], -1).astype(np.float32)
         * np.float32(0.5) + origin.astype(np.float32)) / np.float32(0.3)
    off_face = ~(np.abs(q - np.round(q)) < 1e-4).any(1).reshape(dims)
    assert off_face.sum() > 5000
    np.testing.assert_array_equal(nn_b[off_face], nn_j[off_face])
    np.testing.assert_allclose(sdf_b[off_face], sdf_j[off_face], rtol=1e-5,
                               atol=1e-6)
    # the untrained decoder's SDF shifted by its median over the grid, so
    # that the map mesh has a surface to extract
    mlp = {"w": list(tparams["geo_mlp"]["w"]),
           "b": list(tparams["geo_mlp"]["b"])}
    mlp["b"][-1] = mlp["b"][-1] - float(np.median(sdf_a)) / TConfig().sdf_scale
    args = (tst, tparams["geo_features"], mlp)
    va, fa = plain.recon_map_mesh(*args)
    vb, fb = sharded.recon_map_mesh(*args)
    assert va.shape[0] > 0
    np.testing.assert_array_equal(va, vb)
    np.testing.assert_array_equal(fa, fb)
    assert sharded.n_batches == plain.n_batches


def _system_config(cls):
    """tests/test_torch_probe_modes.py's small configuration under the cell
    probe (the JAX package's choice on the CPU), with `dp_on`; each
    replica's batch is 256 samples (2048 over the 8 replicas)."""
    cfg = cls()
    cfg.track_on = True
    cfg.max_range = 60.0
    cfg.min_range = 0.5
    cfg.vox_down_m = 0.08
    cfg.source_vox_down_m = 0.4
    cfg.voxel_size_m = 0.3
    cfg.sigma_sigmoid_m = 0.1
    cfg.surface_sample_range_m = 0.25
    cfg.loss_weight_on = True
    cfg.bs = 256
    cfg.iters = 3
    cfg.init_iter_ratio = 100
    cfg.bs_new_sample = 64
    cfg.reg_iter_n = 20
    cfg.map_capacity = 1 << 16
    cfg.buffer_size = 1 << 18
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.max_frames = 16
    cfg.probe_mode = "cells"
    cfg.dp_on = True
    cfg.finalize()
    cfg.pool_capacity = 200_000
    return cfg


def _err(a, b):
    dt = np.linalg.norm(a[:3, 3] - b[:3, 3])
    R = a[:3, :3].T @ b[:3, :3]
    return dt, np.degrees(np.arccos(np.clip((np.trace(R) - 1) / 2, -1, 1)))


def test_dp_system_matches_jax():
    """Three synthetic frames through a `dp_on` system of each package (8
    replicas each, both from the JAX system's initial decoder). Their
    draws come from different generators, so the comparison is
    statistical, with test_torch_probe_modes.py's bounds: frame 1 within
    test_torch_slice.py's 10 cm / 0.5 deg of the other package's pose and
    of ground truth, frame 2 within the reference's own spread at this
    size (15 cm / 5 deg of ground truth)."""
    from pin_slam_tpu.slam.system import PinSLAMSystem as JSystem
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene,
        lidar_directions)
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem as TSystem

    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(4, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    js = JSystem(_system_config(JConfig))
    ts = TSystem(_system_config(TConfig), device="cpu",
                 mesh=["cpu"] * NDEV)
    assert len(js.mesh.devices.ravel()) == NDEV and len(ts.mesh) == NDEV
    ts.params["geo_mlp"] = convert.mlp_from_numpy(
        jax.tree.map(np.asarray, js.params["geo_mlp"]), device="cpu")
    out = {}
    for name, sys_ in (("jax", js), ("torch", ts)):
        sys_.set_gt_poses(seq.poses)
        out[name] = []
        for i in range(3):
            out[name].append(sys_.process_frame(i, seq.frame(i)))
            assert i == 0 or bool(sys_.last_tracking.valid), (name, i)
    for other in (out["jax"][1], seq.poses[1]):
        dt, da = _err(out["torch"][1], other)
        assert dt < MAX_DT and da < MAX_DA, (dt, da)
    for name in ("jax", "torch"):
        dt, da = _err(out[name][2], seq.poses[2])
        assert dt < LATE_DT and da < LATE_DA, (name, dt, da)
    assert np.isfinite(ts.params["geo_features"].numpy()).all()
    assert np.isfinite(ts.last_train_losses.numpy()).all()
