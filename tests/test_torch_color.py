"""The port's colour mapping against the JAX package, at small sizes on the
CPU, with the same inputs (numpy seeds) and the same weights (carried by
pin_slam_tpu_torch.convert) on both sides:

* the occupancy and colour decoder heads and the L1 colour loss (1e-6);
* `query_decode`'s colour head on the training's cached-candidate route and
  the cell-probe route under both `weighted_first` values (the tracker's
  join route is held in tests/test_torch_color_track.py): colour (1e-5),
  and its
  gradients w.r.t. the colour features and the colour decoder (1e-5,
  relative to the largest) and w.r.t. the query points (1e-5; 5e-5 under
  `weighted_first=False`, see the test);
* `gather_feature_vectors`' colour half (1e-6);
* one training run (3 iterations) with the colour and semantic terms, the
  random draws handed to both sides: losses (1e-5 relative); trained
  features and decoders within 1e-5 but for the elements where Adam steps
  on the sign of a gradient that is float noise (shares in the test);
* `Mesher.vertex_attributes` (colour, 1e-5).

The colour tracker and a colour system run are in
tests/test_torch_color_track.py.
"""

import numpy as np
import optax
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import decoder as jdec
from pin_slam_tpu.models import losses as jlo
from pin_slam_tpu.models import neural_points as jnpm
from pin_slam_tpu.models.decoder import init_mlp_params as j_init_mlp
from pin_slam_tpu.ops import knn_join as jk
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu.slam import mapper as jmp
from pin_slam_tpu.slam.mesher import MeshConfig as JMeshConfig
from pin_slam_tpu.slam.mesher import Mesher as JMesher
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import procedural_color
from pin_slam_tpu_torch.models import decoder as tdec
from pin_slam_tpu_torch.models import losses as tlo
from pin_slam_tpu_torch.models import neural_points as tnpm
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam import mapper as tmp
from pin_slam_tpu_torch.slam.mesher import MeshConfig as TMeshConfig
from pin_slam_tpu_torch.slam.mesher import Mesher as TMesher

jax.config.update("jax_default_matmul_precision", "highest")
RES, F = 0.4, 8


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread keeps six test workers off each other."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(a):
    return torch.as_tensor(np.array(a))


def _np_mlp(mlp):
    return jax.tree.map(np.asarray, mlp)


def _rel(a, b):
    return float(np.abs(np.asarray(a) - np.asarray(b)).max()
                 / max(np.abs(np.asarray(b)).max(), 1e-12))


def test_occupancy_and_color_heads_and_l1_loss():
    rng = np.random.RandomState(0)
    x = rng.randn(300, F + 3).astype(np.float32)
    for out_dim, j_fn, t_fn in (
            (1, lambda m, v: jdec.occupancy_apply(m, v, 0.044),
             lambda m, v: tdec.occupancy_apply(m, v, 0.044)),
            (3, jdec.color_apply, tdec.color_apply),
            (1, jdec.color_apply, tdec.color_apply)):
        mlp = j_init_mlp(jax.random.PRNGKey(out_dim), F + 3, 64, 1, out_dim)
        tm = convert.mlp_from_numpy(_np_mlp(mlp), device="cpu")
        np.testing.assert_allclose(t_fn(tm, _t(x)).numpy(),
                                   np.asarray(j_fn(mlp, jnp.asarray(x))),
                                   atol=1e-6, rtol=0)
    pred = rng.rand(300, 3).astype(np.float32)
    label = rng.rand(300, 3).astype(np.float32)
    w = rng.rand(300).astype(np.float32) + 0.5
    mask = rng.rand(300) < 0.7
    for weighted in (False, True):
        j = jlo.color_l1_loss(jnp.asarray(pred), jnp.asarray(label),
                              jnp.asarray(w), jnp.asarray(mask),
                              weighted=weighted)
        t = tlo.color_l1_loss(_t(pred), _t(label), _t(w), _t(mask),
                              weighted=weighted)
        assert abs(float(t) - float(j)) <= 1e-6


@pytest.fixture(scope="module")
def world():
    """A JAX map of a wavy plane with random geometry and colour features,
    rotated points, a colour decoder and query points near the surface."""
    rng = np.random.RandomState(0)
    n = 3000
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.rand(n, 2) * 12 - 6
    p[:, 2] = 0.4 * np.sin(p[:, 0]) + 0.2 * np.cos(p[:, 1])
    js = jnpm.init_map_state(1 << 12, 1 << 14, F, color_on=True,
                             with_btable=False)
    js, _ = jnpm.insert_points(js, jnp.asarray(p), jnp.ones(n, bool), 0,
                               jnp.zeros(4), resolution=RES,
                               local_window_dist=50.0, maintain_btable=False)
    cnt = int(js.count)
    c1 = js.capacity + 1
    feats = np.zeros((c1, F), np.float32)
    feats[:cnt] = rng.randn(cnt, F).astype(np.float32) * 0.3
    cfeats = np.zeros((c1, F), np.float32)
    cfeats[:cnt] = rng.randn(cnt, F).astype(np.float32) * 0.5
    quat = np.zeros((c1, 4), np.float32)
    quat[:, 0] = 1.0
    q = rng.randn(cnt, 4).astype(np.float32) * [1, 0.1, 0.1, 0.1]
    quat[:cnt] = q / np.linalg.norm(q, axis=1, keepdims=True)
    js = js.replace(geo_features=jnp.asarray(feats),
                    color_features=jnp.asarray(cfeats),
                    orientations=jnp.asarray(quat),
                    certainty=jnp.asarray(rng.rand(c1).astype(np.float32)))
    mlp = j_init_mlp(jax.random.PRNGKey(3), F + 3, 64, 1, 1)
    cmlp = j_init_mlp(jax.random.PRNGKey(4), F + 3, 64, 1, 3)
    qpts = p[rng.randint(0, n, 600)] + rng.randn(600, 3).astype(
        np.float32) * 0.15
    return js, mlp, cmlp, qpts


def _cfg(cls, weighted_first):
    c = cls()
    c.voxel_size_m = RES
    c.probe_mode = "join"
    c.weighted_first = weighted_first
    return c.finalize()


@pytest.mark.parametrize("route", ["cand", "cells"])
@pytest.mark.parametrize("weighted_first", [True, False])
def test_query_decode_color_head(world, route, weighted_first):
    js, mlp, cmlp, qpts = world
    jqp = jmq.make_query_params(_cfg(JConfig, weighted_first))
    tqp = tmq.make_query_params(_cfg(TConfig, weighted_first))
    state_np = {f: np.asarray(getattr(js, f))
                for f in convert.STATE_FIELDS + convert.COLOR_FIELDS}
    _, ts = convert.from_jax(None, state_np, device="cpu")
    tm = convert.mlp_from_numpy(_np_mlp(mlp), device="cpu")
    tcm = convert.mlp_from_numpy(_np_mlp(cmlp), device="cpu")
    if route == "cells":
        jf, jcf = js.geo_features, js.color_features
        jkw, tkw = dict(), dict(state=ts)
        jstate = js
    else:
        m = jnp.arange(js.capacity) < js.count
        jls = jk.build_local_set(js.positions, m, RES, 4096,
                                 certainty=js.certainty,
                                 orientations=js.orientations)
        tls = convert.lset_from_numpy(jls._asdict(), device="cpu")
        jf, jcf = js.geo_features[jls.gidx], js.color_features[jls.gidx]
        jkw, tkw = dict(lset=jls), dict(lset=tls)
        jstate = None
        if route == "cand":
            # the candidates from the port's k-NN (bit-equal to the JAX
            # package's, tests/test_torch_knn_join.py), fed to both sides
            qn = tnpm.query_neighbors_join(
                _t(qpts), tls, nn_k=tqp.nn_k + 2,
                max_dist2=tqp.join_max_dist2, resolution=RES)
            jkw.update(cand=(jnp.asarray(qn.idx.numpy(), jnp.int32),
                             jnp.asarray(qn.valid.numpy())),
                       cand_pack=(jmq.pack_lset_nodiff(jls), jf))
            tkw.update(cand=(qn.idx, qn.valid))

    def jfun(p, cf, cm):
        o = jmq.query_decode(jstate, jf, mlp, p, jqp, color_features=cf,
                             color_mlp=cm, color_channel=3, **jkw)
        return jnp.sum(o.color), o

    (jgp, jgc, jgm), jo = jax.grad(jfun, argnums=(0, 1, 2), has_aux=True)(
        jnp.asarray(qpts), jcf, cmlp)
    p = _t(qpts).requires_grad_(True)
    tcf = _t(jcf).requires_grad_(True)
    for t in tcm["w"] + tcm["b"]:
        t.requires_grad_(True)
    tf = _t(jf)
    if route == "cand":
        tkw["cand_pack"] = (tmq.pack_lset_nodiff(tls), tf)
    to = tmq.query_decode(tf, tm, p, tqp, color_features=tcf,
                          color_mlp=tcm, color_channel=3, **tkw)
    to.color.sum().backward()
    assert to.color.shape == (len(qpts), 3)
    np.testing.assert_allclose(to.color.detach().numpy(),
                               np.asarray(jo.color), atol=1e-5, rtol=0)
    # under weighted_first=False the point gradient sums terms of size
    # |dw/dq| x colour (~2/d per unit weight, 88 for the closest query
    # here, d = 2.3 cm) that cancel to O(0.1): float32 rounds those terms
    # differently in XLA and torch by up to 1.4e-5 (measured), hence 5e-5
    np.testing.assert_allclose(p.grad.numpy(), np.asarray(jgp),
                               atol=1e-5 if weighted_first else 5e-5,
                               rtol=1e-5)
    assert _rel(tcf.grad.numpy(), jgc) < 1e-5
    for tg, jg in zip(tcm["w"] + tcm["b"], jgm["w"] + jgm["b"]):
        assert _rel(tg.grad.numpy(), jg) < 1e-5


def test_gather_feature_vectors_color(world):
    js, _, _, qpts = world
    state_np = {f: np.asarray(getattr(js, f))
                for f in convert.STATE_FIELDS + convert.COLOR_FIELDS}
    _, ts = convert.from_jax(None, state_np, device="cpu")
    jqp = jmq.make_query_params(_cfg(JConfig, True))
    jq = jnpm.query_neighbors(js, jnp.asarray(qpts), offsets=jqp.offsets_np,
                              resolution=RES, nn_k=6,
                              max_dist2=jqp.max_dist2, probe_mode="cells")
    tq = tnpm.QueryNeighbors(idx=_t(jq.idx).long(), dist2=_t(jq.dist2),
                             valid=_t(jq.valid), nn_count=_t(jq.nn_count))
    jg, jc = jnpm.gather_feature_vectors(js, jq, jnp.asarray(qpts),
                                         color=True,
                                         rotate_by_orientation=True)
    tg, tc = tnpm.gather_feature_vectors(ts, tq, _t(qpts), color=True,
                                         rotate_by_orientation=True)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-6, rtol=0)
    np.testing.assert_allclose(tc.numpy(), np.asarray(jc), atol=1e-6, rtol=0)


# --------------------------------------------------------------- training


BS, BS_NEW, N_CLASS = 512, 128, 4
LOSS_KW = dict(sigma_sigmoid_m=0.044, loss_weight_on=True,
               ekional_loss_on=True, weight_e=0.5,
               numerical_grad_eps=RES * 0.2, gradient_decimation=10,
               main_loss_type="bce", surface_sample_range_m=0.25,
               semantic_on=True, weight_s=1.0, freespace_label_on=False,
               sem_label_decimation=1, color_on=True, weight_i=1.0,
               color_channel=3)


def _jax_draws(key, n_iters, pool_count, new_count, subset_hist=2048):
    """The draws `make_train_loop` makes from `key` in its subset mode."""
    keys = jax.random.split(key, n_iters + 2)
    S_h = max(BS, min(subset_hist, n_iters * BS))
    hist = jax.random.randint(keys[1], (S_h,), 0, max(pool_count, 1))
    sel = [jax.random.randint(jax.random.split(k)[0], (BS_NEW,), 0,
                              max(new_count, 1)) for k in keys[2:]]
    return {"hist": _t(hist).long(), "new_sel": _t(jnp.stack(sel)).long()}


def test_train_loop_color_and_semantic(world):
    """Three iterations on a pool with colour and semantic labels: the
    geometry and colour features, the three decoders, Adam."""
    js, mlp, cmlp, _ = world
    rng = np.random.RandomState(5)
    P, cnt_p = 12000, 9000
    cnt = int(js.count)
    base = np.asarray(js.positions)[rng.randint(0, cnt, cnt_p)]
    off = rng.randn(cnt_p).astype(np.float32) * 0.3
    coord = np.zeros((P + 1, 3), np.float32)
    coord[:cnt_p] = base + off[:, None] * np.array([0, 0, 1], np.float32)
    sdf = np.zeros(P + 1, np.float32)
    sdf[:cnt_p] = -off
    w = np.zeros(P + 1, np.float32)
    w[:cnt_p] = np.where(np.abs(off) < 0.3, 1.0, -1.0) * (
        0.6 + rng.rand(cnt_p) * 0.8)
    w[:cnt_p][rng.rand(cnt_p) < 0.05] = 0.0
    ts_ = np.zeros(P + 1, np.int32)
    ts_[:cnt_p] = rng.randint(0, 4, cnt_p)
    sem = np.zeros(P + 1, np.int32)
    sem[:cnt_p] = rng.randint(0, N_CLASS, cnt_p)
    col = np.zeros((P + 1, 3), np.float32)
    col[:cnt_p] = procedural_color(coord[:cnt_p].astype(np.float64))
    new_idx = np.zeros(BS_NEW * 8 + 1, np.int32)
    new_idx[:300] = rng.randint(cnt_p - 3000, cnt_p, 300)
    jpool = jmp.init_pool(P, BS_NEW * 8, True, 3).replace(
        coord=jnp.asarray(coord), sdf_label=jnp.asarray(sdf),
        weight=jnp.asarray(w), ts=jnp.asarray(ts_),
        sem_label=jnp.asarray(sem), color_label=jnp.asarray(col),
        count=jnp.int32(cnt_p), new_idx=jnp.asarray(new_idx),
        new_count=jnp.int32(300))
    pool_np = {f: np.asarray(getattr(jpool, f))
               for f in convert.POOL_FIELDS + convert.POOL_LABEL_FIELDS}
    tpool = convert.pool_from_numpy(pool_np, device="cpu")
    smlp = j_init_mlp(jax.random.PRNGKey(6), F + 3, 64, 1, N_CLASS)

    m = jnp.arange(js.capacity) < js.count
    jls = jk.build_local_set(js.positions, m, RES, 4096,
                             certainty=js.certainty, ts_update=js.ts_update)
    tls = convert.lset_from_numpy(jls._asdict(), device="cpu")
    jqp = jmq.make_query_params(_cfg(JConfig, False))
    tqp = tmq.make_query_params(_cfg(TConfig, False))
    n_iters, key = 3, jax.random.PRNGKey(9)
    opt = optax.adam(0.01, eps=1e-15)
    jloop = jmp.make_train_loop(jqp, opt, n_iters=n_iters, bs=BS,
                                bs_new=BS_NEW, train_decoder=True,
                                loss_kwargs=LOSS_KW, subset_hist=2048)
    params = {"geo_features": js.geo_features,
              "color_features": js.color_features, "geo_mlp": mlp,
              "color_mlp": cmlp, "sem_mlp": smlp}
    jp, _, jst, _, jlosses = jloop(params, opt.init(params), js, jpool, key,
                                   None, jnp.bool_(True), jls)

    state_np = {f: np.asarray(getattr(js, f))
                for f in convert.STATE_FIELDS + convert.COLOR_FIELDS}
    tparams, tst = convert.from_jax(
        {"geo_mlp": _np_mlp(mlp), "color_mlp": _np_mlp(cmlp),
         "sem_mlp": _np_mlp(smlp)}, state_np, device="cpu")
    tloop = tmp.make_train_loop(tqp, lr=0.01, adam_eps=1e-15,
                                n_iters=n_iters, bs=BS, bs_new=BS_NEW,
                                train_decoder=True, loss_kwargs=LOSS_KW,
                                subset_hist=2048)
    draws = _jax_draws(key, n_iters, cnt_p, 300)
    tp_, tst, tlosses = tloop(tparams, tst, tpool, None, torch.tensor(True),
                              tls, draws=draws)
    np.testing.assert_allclose(tlosses.numpy(), np.asarray(jlosses),
                               rtol=1e-5)
    for name in ("geo_features", "color_features"):
        got = getattr(tst, name).numpy()
        want = np.asarray(getattr(jst, name))
        df = np.abs(got - want)
        moved = np.abs(want - np.asarray(getattr(js, name))) > 0
        assert moved.any(), name
        # Adam steps ~lr x sign(g): an element whose gradient is float
        # noise may step the other way (2 lr x steps); every other
        # element agrees to 1e-5
        close = df <= 1e-5
        assert close.mean() > 0.995, (name, close.mean())
        assert df.max() <= 2 * 0.01 * n_iters
    for name in ("geo_mlp", "color_mlp", "sem_mlp"):
        got = np.concatenate([t.numpy().ravel()
                              for t in tp_[name]["w"] + tp_[name]["b"]])
        want = np.concatenate([np.asarray(t).ravel()
                               for t in jp[name]["w"] + jp[name]["b"]])
        df = np.abs(got - want)
        # the same Adam effect on weights whose gradient is ~0 (hidden
        # units rarely active): measured 98.6 % of the semantic decoder's
        # elements within 1e-5, the rest within 3e-4
        assert (df <= 1e-5).mean() > 0.98, name
        assert df.max() <= 1e-3, name


# ------------------------------------------------------- vertex attributes


def test_vertex_attributes_color(world):
    js, mlp, cmlp, qpts = world
    for weighted_first in (True, False):
        jqp = jmq.make_query_params(_cfg(JConfig, weighted_first))
        tqp = tmq.make_query_params(_cfg(TConfig, weighted_first))
        jm = JMesher(jqp, JMeshConfig(infer_bs=256), color_channel=3)
        tm_ = TMesher(tqp, TMeshConfig(infer_bs=256), color_channel=3)
        jc, js_ = jm.vertex_attributes(
            js, js.geo_features, mlp, qpts, color_features=js.color_features,
            color_mlp=cmlp, color_channel=3)
        state_np = {f: np.asarray(getattr(js, f))
                    for f in convert.STATE_FIELDS + convert.COLOR_FIELDS}
        tparams, ts = convert.from_jax(
            {"geo_mlp": _np_mlp(mlp), "color_mlp": _np_mlp(cmlp)}, state_np,
            device="cpu")
        tc, tsem = tm_.vertex_attributes(
            ts, tparams["geo_features"], tparams["geo_mlp"], qpts,
            color_features=tparams["color_features"],
            color_mlp=tparams["color_mlp"], color_channel=3)
        assert js_ is None and tsem is None
        np.testing.assert_allclose(tc, jc, atol=1e-5, rtol=0)
