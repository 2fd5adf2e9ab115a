"""The port's mapping (pin_slam_tpu_torch.slam.mapper) against the JAX
package: one training batch's loss and its gradients w.r.t. the compact
features and the decoder (<= 1e-5 relative), and whole per-frame training
runs on both loop paths with the same random draws handed to both sides.
Adam (torch.optim.Adam vs optax.adam) and float sums round differently, so
the runs compare losses (<= 1e-4 relative), certainty (<= 1e-4) and
timestamps (exact); trained features may differ by the optimizer's
per-step size where a gradient is ~0 and its sign is noise."""

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
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu.slam import mapper as jmp
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.models import neural_points as tnpm
from pin_slam_tpu_torch.ops import knn_join as tkj
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam import mapper as tmp

jax.config.update("jax_default_matmul_precision", "highest")
RES, F, BS, BS_NEW = 0.4, 8, 512, 128
LOSS_KW = dict(sigma_sigmoid_m=0.044, loss_weight_on=True,
               ekional_loss_on=True, weight_e=0.5,
               numerical_grad_eps=RES * 0.2, gradient_decimation=10,
               main_loss_type="bce")
J_LOSS_KW = dict(LOSS_KW, surface_sample_range_m=0.25)


def _t(a):
    return torch.as_tensor(np.array(a))


def _cfg(cls, weighted_first=True):
    c = cls()
    c.weighted_first = weighted_first
    c.voxel_size_m = RES
    c.probe_mode = "join"
    return c.finalize()


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    n = 5000
    surf = np.zeros((n, 3), np.float32)
    surf[:, :2] = rng.rand(n, 2) * 16 - 8
    surf[:, 2] = 0.4 * np.sin(surf[:, 0])
    js = jnpm.init_map_state(1 << 13, 1 << 15, F, color_on=False,
                             with_btable=False)
    js, _ = jnpm.insert_points(js, jnp.asarray(surf), jnp.ones(n, bool), 0,
                               jnp.zeros(4), resolution=RES,
                               local_window_dist=50.0, maintain_btable=False)
    cnt = int(js.count)
    feats = np.zeros((js.capacity + 1, F), np.float32)
    feats[:cnt] = rng.randn(cnt, F).astype(np.float32) * 0.1
    cert = np.zeros(js.capacity + 1, np.float32)
    cert[:cnt] = rng.rand(cnt) * 2
    tsu = np.zeros(js.capacity + 1, np.int32)
    tsu[:cnt] = rng.randint(0, 3, cnt)
    js = js.replace(geo_features=jnp.asarray(feats),
                    certainty=jnp.asarray(cert), ts_update=jnp.asarray(tsu))

    # a replay pool: surface, near-surface and free-space samples, a few
    # dead rows, and a "new" subset
    P, cnt_p = 20000, 15000
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
    new_idx[:300] = rng.randint(cnt_p - 3000, cnt_p, 300)
    jpool = jmp.init_pool(P, BS_NEW * 8, False, 0).replace(
        coord=jnp.asarray(coord), sdf_label=jnp.asarray(sdf),
        weight=jnp.asarray(w), ts=jnp.asarray(ts),
        count=jnp.int32(cnt_p), new_idx=jnp.asarray(new_idx),
        new_count=jnp.int32(300))
    tpool = tmp.init_pool(P, BS_NEW * 8).replace(
        coord=_t(coord), sdf_label=_t(sdf), weight=_t(w), ts=_t(ts),
        count=torch.tensor(cnt_p), new_idx=_t(new_idx).long(),
        new_count=torch.tensor(300))

    m = jnp.arange(js.capacity) < js.count
    jls = jk.build_local_set(js.positions, m, RES, 4096,
                             certainty=js.certainty, ts_update=js.ts_update)
    tls = tkj.build_local_set(_t(js.positions), _t(m), RES, 4096,
                              certainty=_t(js.certainty),
                              ts_update=_t(js.ts_update))
    mlp = j_init_mlp(jax.random.PRNGKey(1), F + 3, 64, 1, 1)
    return js, jpool, tpool, jls, tls, mlp


def _rel(a, b):
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-12))


def test_mapping_loss_and_grads(world):
    _mapping_loss_and_grads(world, True)


def test_mapping_loss_and_grads_per_neighbour_decode(world):
    """weighted_first=False: the decode at every neighbour, reduced by the
    IDW weights, in the loss and in the eikonal gradient."""
    _mapping_loss_and_grads(world, False)


def _mapping_loss_and_grads(world, weighted_first):
    js, jpool, tpool, jls, tls, mlp = world
    jqp = jmq.make_query_params(_cfg(JConfig, weighted_first))
    tqp = tmq.make_query_params(_cfg(TConfig, weighted_first))
    assert tqp.weighted_first is weighted_first
    rng = np.random.RandomState(2)
    idx = rng.randint(0, 16000, BS)              # some rows past `count`
    mask = idx < 15000
    batch_np = {"coord": np.asarray(jpool.coord)[idx],
                "sdf_label": np.asarray(jpool.sdf_label)[idx],
                "weight": np.asarray(jpool.weight)[idx],
                "ts": np.asarray(jpool.ts)[idx]}
    jqn = jnpm.query_neighbors_join(
        None, jnp.asarray(batch_np["coord"]), jls, nn_k=jqp.nn_k + 2,
        max_dist2=jqp.join_max_dist2, resolution=RES)
    tqn = tnpm.query_neighbors_join(
        _t(batch_np["coord"]), tls, nn_k=tqp.nn_k + 2,
        max_dist2=tqp.join_max_dist2, resolution=RES)
    np.testing.assert_array_equal(tqn.idx.numpy(), np.asarray(jqn.idx))
    lf_j = np.asarray(js.geo_features[jls.gidx])

    def jl(params):
        return jmp.mapping_loss(
            params, None, jpool,
            jmp.BatchIdx(idx=jnp.zeros(BS, jnp.int32),
                         mask=jnp.asarray(mask)),
            jqp, None, lset=jls, cand=(jqn.idx, jqn.valid),
            batch={k: jnp.asarray(v) for k, v in batch_np.items()},
            **J_LOSS_KW)

    (jloss, jaux), jg = jax.value_and_grad(jl, has_aux=True)(
        {"geo_features": jnp.asarray(lf_j), "geo_mlp": mlp})
    tf = _t(lf_j).requires_grad_(True)
    tmlp = convert.mlp_from_numpy(jax.tree.map(np.asarray, mlp))
    for p in tmlp["w"] + tmlp["b"]:
        p.requires_grad_(True)
    tloss, taux = tmp.mapping_loss(
        tf, tmlp, {k: _t(v) for k, v in batch_np.items()}, _t(mask),
        tqn.idx, tqn.valid, tls, tqp, **LOSS_KW)
    tloss.backward()
    assert float(tloss) == pytest.approx(float(jloss), rel=1e-5)
    assert float(taux["eikonal_loss"]) == pytest.approx(
        float(jaux["eikonal_loss"]), rel=1e-5)
    assert _rel(tf.grad.numpy(), np.asarray(jg["geo_features"])) < 1e-5
    for tp_, jp_ in zip(tmlp["w"] + tmlp["b"],
                        jg["geo_mlp"]["w"] + jg["geo_mlp"]["b"]):
        assert _rel(tp_.grad.numpy(), np.asarray(jp_)) < 1e-5
    np.testing.assert_allclose(taux["w"].detach().numpy(),
                               np.asarray(jaux["w"]), atol=1e-6)
    # this batch's certainty / timestamp side effects on the local rows
    jc, jts = jmp.accumulate_certainty_local(jls.cert, jls.ts_upd, jaux,
                                             jls.cap)
    tc, tts = tmp.accumulate_certainty_local(
        tls.cert, tls.ts_upd, dict(taux, w=taux["w"].detach()), tls.cap)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-5)
    np.testing.assert_array_equal(tts.numpy(), np.asarray(jts))


def _jax_draws(key, n_iters, subset, pool_count, new_count):
    keys = jax.random.split(key, n_iters + 2)
    if subset:
        S_h = max(BS, min(2048, n_iters * BS))
        hist = jax.random.randint(keys[1], (S_h,), 0, max(pool_count, 1))
        sel = [jax.random.randint(jax.random.split(k)[0], (BS_NEW,), 0,
                                  max(new_count, 1)) for k in keys[2:]]
    else:
        hist, sel = [], []
        for k in keys[2:]:
            k1, k2 = jax.random.split(jax.random.split(k)[0])
            hist.append(jax.random.randint(k1, (BS,), 0, max(pool_count, 1)))
            sel.append(jax.random.randint(k2, (BS_NEW,), 0,
                                          max(new_count, 1)))
        hist = jnp.stack(hist)
    return {"hist": _t(hist).long(), "new_sel": _t(jnp.stack(sel)).long()}


@pytest.mark.parametrize("n_iters,use_new", [(3, True), (3, False),
                                             (34, True)])
def test_train_loop(world, n_iters, use_new):
    _train_loop(world, n_iters, use_new, True)


@pytest.mark.parametrize("n_iters,use_new", [(3, True), (34, False)])
def test_train_loop_per_neighbour_decode(world, n_iters, use_new):
    _train_loop(world, n_iters, use_new, False)


def _train_loop(world, n_iters, use_new, weighted_first):
    js, jpool, tpool, jls, tls, mlp = world
    jqp = jmq.make_query_params(_cfg(JConfig, weighted_first))
    tqp = tmq.make_query_params(_cfg(TConfig, weighted_first))
    key = jax.random.PRNGKey(7)
    opt = optax.adam(0.01, eps=1e-15)
    jloop = jmp.make_train_loop(jqp, opt, n_iters=n_iters, bs=BS,
                                bs_new=BS_NEW, train_decoder=True,
                                loss_kwargs=J_LOSS_KW, subset_hist=2048)
    params = {"geo_features": js.geo_features, "geo_mlp": mlp}
    jp, _, jst, _, jlosses = jloop(params, opt.init(params), js, jpool, key,
                                   None, jnp.bool_(use_new), jls)
    s_np = {f: np.asarray(getattr(js, f)) for f in convert.STATE_FIELDS}
    tparams, tst = convert.from_jax(
        {"geo_mlp": jax.tree.map(np.asarray, mlp)}, s_np)
    tloop = tmp.make_train_loop(tqp, lr=0.01, adam_eps=1e-15,
                                n_iters=n_iters, bs=BS, bs_new=BS_NEW,
                                train_decoder=True, loss_kwargs=LOSS_KW,
                                subset_hist=2048)
    draws = _jax_draws(key, n_iters, n_iters <= 32, 15000, 300)
    tp_, tst, tlosses = tloop(tparams, tst, tpool, None,
                              torch.tensor(use_new), tls, draws=draws)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-4)
    np.testing.assert_array_equal(tst.ts_update.numpy(),
                                  np.asarray(jst.ts_update))
    # the JAX package takes each row's certainty sum as the difference of a
    # float32 running sum over ALL contributions (a TPU-friendly sorted
    # segment sum), so its absolute error grows with the total added: a few
    # float32 ulps of that total
    total = float(np.sum(jst.certainty) - np.sum(js.certainty))
    np.testing.assert_allclose(tst.certainty.numpy(),
                               np.asarray(jst.certainty),
                               atol=8 * 2.0 ** -24 * total, rtol=1e-4)
    df = np.abs(tst.geo_features.numpy() - np.asarray(jst.geo_features))
    assert np.median(df[df > 0]) < 1e-4 if (df > 0).any() else True
    assert df.max() <= 2 * 0.01 * n_iters
