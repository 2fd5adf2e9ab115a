"""The training options no shipped YAML turns on, in the port against the
JAX package on identical inputs, on the CPU:

* one batch's loss and its gradients w.r.t. the features and the decoder
  with the gradient-consistency term and the projective label correction,
  on the join route (a local set, cached candidates) and on the state
  route (the whole map through the cell and the brick probe), the
  consistency term's uniform shifts drawn from the JAX key and handed to
  the port: loss <= 1e-5 relative (1e-4 with the correction: it divides
  numerical SDF gradients, differences of float32 decodes over 2 eps, by
  their norms, and the jitted JAX loss itself moves by ~2e-5 against its
  eager self there), gradients <= 1e-4 of their largest element;
* the eikonal term through the base query's neighbours
  (`eik_shared_neighbors`) on the state route: the same bounds;
* a whole training run with both options on the state route (the
  whole-map training, Adam over the [C+1, F] features, certainty every
  iteration), with every draw handed over: losses <= 1e-4
  relative, update timestamps exact, certainty <= 1e-4 relative, features
  within 1e-4 on 99 % of their elements (where a gradient is ~0 its sign
  is rounding, and Adam steps by lr either way);
* both positional encoders, to 1e-6, the Gaussian one with the JAX
  encoder's random matrix carried across (`convert.gaussian_pe_from_jax`).
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jnpm
from pin_slam_tpu.models import pos_encoding as jpe
from pin_slam_tpu.models.decoder import init_mlp_params as j_init_mlp
from pin_slam_tpu.ops import knn_join as jk
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu.slam import mapper as jmp
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.models import neural_points as tnpm
from pin_slam_tpu_torch.models import pos_encoding as tpe
from pin_slam_tpu_torch.ops import knn_join as tkj
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam import mapper as tmp

jax.config.update("jax_default_matmul_precision", "highest")
RES, F, BS, BS_NEW, T = 0.4, 8, 256, 64, 8
CONS_M = BS // 4
LOSS_KW = dict(sigma_sigmoid_m=0.044, loss_weight_on=True,
               ekional_loss_on=True, weight_e=0.5,
               numerical_grad_eps=RES * 0.2, gradient_decimation=10,
               main_loss_type="bce", surface_sample_range_m=0.25,
               weight_c=0.5, consistency_count=CONS_M,
               consistency_range=0.05)
LOSS_RTOL, PROJ_LOSS_RTOL, GRAD_RTOL = 1e-5, 1e-4, 1e-4


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfg(cls, mode):
    c = cls()
    c.voxel_size_m = RES
    c.probe_mode = mode
    return c.finalize()


@pytest.fixture(scope="module")
def world():
    """A wavy map with features, certainty and update timestamps (both
    packages, with brick caches), a replay pool of near-surface and
    free-space samples from T frames, per-frame sensor origins, a local
    set over the map and a decoder."""
    rng = np.random.RandomState(0)
    n = 4000
    surf = np.zeros((n, 3), np.float32)
    surf[:, :2] = rng.rand(n, 2) * 12 - 6
    surf[:, 2] = 0.4 * np.sin(surf[:, 0])
    js = jnpm.init_map_state(1 << 13, 1 << 15, F, color_on=False,
                             with_btable=True)
    js, _ = jax.jit(lambda s, p: jnpm.insert_points(
        s, p, jnp.ones(n, bool), 0, jnp.zeros(4), resolution=RES,
        local_window_dist=50.0))(js, jnp.asarray(surf))
    cnt = int(js.count)
    c1 = js.capacity + 1
    feats = np.zeros((c1, F), np.float32)
    feats[:cnt] = rng.randn(cnt, F).astype(np.float32) * 0.1
    cert = np.zeros(c1, np.float32)
    cert[:cnt] = rng.rand(cnt) * 2
    tsu = np.zeros(c1, np.int32)
    tsu[:cnt] = rng.randint(0, 3, cnt)
    js = js.replace(geo_features=jnp.asarray(feats),
                    certainty=jnp.asarray(cert), ts_update=jnp.asarray(tsu))

    P, cnt_p = 8000, 6000
    base = surf[rng.randint(0, n, cnt_p)]
    off = rng.randn(cnt_p).astype(np.float32) * 0.3
    coord = np.zeros((P + 1, 3), np.float32)
    coord[:cnt_p] = base + off[:, None] * np.array([0, 0, 1], np.float32)
    sdf = np.zeros(P + 1, np.float32)
    sdf[:cnt_p] = -off
    w = np.zeros(P + 1, np.float32)
    w[:cnt_p] = np.where(np.abs(off) < 0.3, 1.0, -1.0) * (
        0.6 + rng.rand(cnt_p) * 0.8)
    w[:cnt_p][rng.rand(cnt_p) < 0.05] = 0.0
    ts = np.zeros(P + 1, np.int32)
    ts[:cnt_p] = rng.randint(0, 4, cnt_p)
    new_idx = np.zeros(BS_NEW * 8 + 1, np.int32)
    new_idx[:100] = rng.randint(cnt_p - 1000, cnt_p, 100)
    jpool = jmp.init_pool(P, BS_NEW * 8, False, 0).replace(
        coord=jnp.asarray(coord), sdf_label=jnp.asarray(sdf),
        weight=jnp.asarray(w), ts=jnp.asarray(ts),
        count=jnp.int32(cnt_p), new_idx=jnp.asarray(new_idx),
        new_count=jnp.int32(100))
    tpool = tmp.init_pool(P, BS_NEW * 8).replace(
        coord=_t(coord), sdf_label=_t(sdf), weight=_t(w), ts=_t(ts),
        count=torch.tensor(cnt_p), new_idx=_t(new_idx).long(),
        new_count=torch.tensor(100))
    origins = (rng.randn(T, 3) * np.array([2.0, 2.0, 0.2]) + np.array(
        [0.0, 0.0, 2.0])).astype(np.float32)
    travel = np.arange(T, dtype=np.float32) * 2.0

    m = jnp.arange(js.capacity) < js.count
    jls = jk.build_local_set(js.positions, m, RES, 4096,
                             certainty=js.certainty, ts_update=js.ts_update)
    tls = tkj.build_local_set(_t(js.positions), _t(m), RES, 4096,
                              certainty=_t(js.certainty),
                              ts_update=_t(js.ts_update))
    mlp = j_init_mlp(jax.random.PRNGKey(1), F + 3, 32, 1, 1)
    return dict(js=js, jpool=jpool, tpool=tpool, jls=jls, tls=tls, mlp=mlp,
                origins=origins, travel=travel)


def _tstate(js):
    st = {f: np.asarray(getattr(js, f)) for f in
          convert.STATE_FIELDS + convert.BRICK_FIELDS}
    return convert.from_jax(None, st, device="cpu")[1]


def _lfs(w, cur_ts=3):
    jlf = jmq.LocalFilter(jnp.asarray(w["travel"]), jnp.int32(cur_ts), 50.0,
                          sensor_origins=jnp.asarray(w["origins"]))
    tlf = tmq.LocalFilter(_t(w["travel"]), cur_ts, 50.0,
                          sensor_origins=_t(w["origins"]))
    return jlf, tlf


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


@pytest.mark.parametrize("route,opts", [
    ("join", ("consistency", "proj")), ("cells", ("consistency", "proj")),
    ("brick", ("consistency",)), ("cells", ("eik_shared",))])
def test_loss_and_grads_with_options(world, route, opts):
    js, jpool, tpool = world["js"], world["jpool"], world["tpool"]
    jqp = jmq.make_query_params(_cfg(JConfig, route))
    tqp = tmq.make_query_params(_cfg(TConfig, route))
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 6500, BS)               # some rows past `count`
    mask = idx < 6000
    batch_np = {"coord": np.asarray(jpool.coord)[idx],
                "sdf_label": np.asarray(jpool.sdf_label)[idx],
                "weight": np.asarray(jpool.weight)[idx],
                "ts": np.asarray(jpool.ts)[idx]}
    kc = jax.random.PRNGKey(9)
    on = dict(consistency_loss_on="consistency" in opts,
              proj_correction_on="proj" in opts)
    jkw = dict(LOSS_KW, **on)
    tkw = dict(LOSS_KW, **on,
               cons_u=_t(jax.random.uniform(kc, (CONS_M, 3))))
    if "eik_shared" in opts:
        jkw["eik_shared_neighbors"] = tkw["eik_shared_neighbors"] = True
    jlf, tlf = _lfs(world)
    jbatch = {k: jnp.asarray(v) for k, v in batch_np.items()}
    tbatch = {k: _t(v) for k, v in batch_np.items()}
    bidx = jmp.BatchIdx(idx=jnp.zeros(BS, jnp.int32), mask=jnp.asarray(mask))
    tmlp = convert.mlp_from_numpy(jax.tree.map(np.asarray, world["mlp"]),
                                  device="cpu")
    for p in tmlp["w"] + tmlp["b"]:
        p.requires_grad_(True)
    if route == "join":
        jls, tls = world["jls"], world["tls"]
        jqn = jnpm.query_neighbors_join(
            None, jbatch["coord"], jls, nn_k=jqp.nn_k + 2,
            max_dist2=jqp.join_max_dist2, resolution=RES)
        tqn = tnpm.query_neighbors_join(
            tbatch["coord"], tls, nn_k=tqp.nn_k + 2,
            max_dist2=tqp.join_max_dist2, resolution=RES)
        feats = np.asarray(js.geo_features[jls.gidx])

        def jl(params):
            return jmp.mapping_loss(params, None, jpool, bidx, jqp, jlf,
                                    key=kc, lset=jls,
                                    cand=(jqn.idx, jqn.valid), batch=jbatch,
                                    **jkw)

        tf = _t(feats).requires_grad_(True)
        tloss, taux = tmp.mapping_loss(tf, tmlp, tbatch, _t(mask), tqn.idx,
                                       tqn.valid, tls, tqp, lf=tlf, **tkw)
    else:
        feats = np.asarray(js.geo_features)
        ts = _tstate(js)

        def jl(params):
            return jmp.mapping_loss(params, js, jpool, bidx, jqp, jlf,
                                    key=kc, batch=jbatch, **jkw)

        tf = _t(feats).requires_grad_(True)
        tloss, taux = tmp.mapping_loss(tf, tmlp, tbatch, _t(mask), None,
                                       None, None, tqp, state=ts, lf=tlf,
                                       **tkw)
    (jloss, jaux), jg = jax.jit(jax.value_and_grad(jl, has_aux=True))(
        {"geo_features": jnp.asarray(feats), "geo_mlp": world["mlp"]})
    tloss.backward()
    assert float(tloss) == pytest.approx(
        float(jloss), rel=PROJ_LOSS_RTOL if "proj" in opts else LOSS_RTOL)
    if "consistency" in opts:
        assert float(taux["consistency_loss"]) > 0.01
    np.testing.assert_array_equal(taux["qn"].idx.numpy(),
                                  np.asarray(jaux["qn"].idx))
    assert _rel(tf.grad.numpy(), np.asarray(jg["geo_features"])) < GRAD_RTOL
    for tp_, jp_ in zip(tmlp["w"] + tmlp["b"],
                        jg["geo_mlp"]["w"] + jg["geo_mlp"]["b"]):
        assert _rel(tp_.grad.numpy(), np.asarray(jp_)) < GRAD_RTOL


def _whole_map_draws(key, n_iters):
    """The draws the JAX package's whole-map training makes from `key`."""
    hist, sel, cons = [], [], []
    for k in jax.random.split(key, n_iters + 1)[1:]:
        kb, kc = jax.random.split(k)
        k1, k2 = jax.random.split(kb)
        hist.append(jax.random.randint(k1, (BS,), 0, 6000))
        sel.append(jax.random.randint(k2, (BS_NEW,), 0, 100))
        cons.append(jax.random.uniform(kc, (CONS_M, 3)))
    return {"hist": _t(jnp.stack(hist)).long(),
            "new_sel": _t(jnp.stack(sel)).long(),
            "cons_u": _t(jnp.stack(cons))}


def test_train_loop_with_options(world):
    js, jpool, tpool = world["js"], world["jpool"], world["tpool"]
    n_iters = 3
    jqp = jmq.make_query_params(_cfg(JConfig, "cells"))
    tqp = tmq.make_query_params(_cfg(TConfig, "cells"))
    kw = dict(LOSS_KW, consistency_loss_on=True, proj_correction_on=True)
    key = jax.random.PRNGKey(7)
    opt = optax.adam(0.01, eps=1e-15)
    jloop = jmp.make_train_loop(jqp, opt, n_iters=n_iters, bs=BS,
                                bs_new=BS_NEW, train_decoder=True,
                                loss_kwargs=kw, subset_hist=1024)
    params = {"geo_features": js.geo_features, "geo_mlp": world["mlp"]}
    jlf, tlf = _lfs(world)
    jp, _, jst, _, jlosses = jloop(params, opt.init(params), js, jpool, key,
                                   jlf, jnp.bool_(True), None)
    tparams, tst = convert.from_jax(
        {"geo_mlp": jax.tree.map(np.asarray, world["mlp"])},
        {f: np.asarray(getattr(js, f)) for f in
         convert.STATE_FIELDS + convert.BRICK_FIELDS}, device="cpu")
    tloop = tmp.make_train_loop(tqp, lr=0.01, adam_eps=1e-15,
                                n_iters=n_iters, bs=BS, bs_new=BS_NEW,
                                train_decoder=True, loss_kwargs=kw,
                                subset_hist=1024)
    draws = _whole_map_draws(key, n_iters)
    terms = {}
    _, tst, tlosses = tloop(tparams, tst, tpool, None, torch.tensor(True),
                            None, draws=draws, lf=tlf, terms=terms)
    assert terms["consistency_loss"].shape == (n_iters,)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    np.testing.assert_array_equal(tst.ts_update.numpy(),
                                  np.asarray(jst.ts_update))
    np.testing.assert_allclose(tst.certainty.numpy(),
                               np.asarray(jst.certainty), rtol=1e-4,
                               atol=1e-6)
    # the JAX loop returns the trained features in its params
    df = np.abs(tst.geo_features.numpy() - np.asarray(jp["geo_features"]))
    assert df.max() <= 2 * 0.01 * n_iters
    assert (df > 1e-4).mean() < 0.01


def test_positional_encoders_match():
    rng = np.random.RandomState(3)
    x = (rng.rand(64, 6, 3).astype(np.float32) - 0.5) * 0.8
    for bands in (0, 4):
        je = jpe.PositionalEncoder(freq=200.0, num_bands=bands)
        te = tpe.PositionalEncoder(freq=200.0, num_bands=bands)
        assert te.out_dim == je.out_dim == 3 * (2 * bands + 1)
        np.testing.assert_allclose(te(_t(x)).numpy(),
                                   np.asarray(je(jnp.asarray(x))),
                                   atol=1e-6, rtol=0)
    for bands in (0, 8):
        jg = jpe.GaussianFourierFeatures(jax.random.PRNGKey(2), freq=20.0,
                                         num_bands=bands)
        tg = convert.gaussian_pe_from_jax(jg.B, freq=20.0, device="cpu")
        assert tg.out_dim == jg.out_dim == 2 * bands + 3
        np.testing.assert_allclose(tg(_t(x)).numpy(),
                                   np.asarray(jg(jnp.asarray(x))),
                                   atol=1e-6, rtol=0)
    drawn = tpe.GaussianFourierFeatures(torch.Generator().manual_seed(0),
                                        num_bands=8)
    assert drawn.B.shape == (3, 8) and drawn(_t(x)).shape == (64, 6, 19)
