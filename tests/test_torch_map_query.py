"""The port's query + decode (pin_slam_tpu_torch.slam.map_query) against
the JAX package on one map, one decoder and one query set: SDF and its
spatial gradient (<= 1e-5), the cached-candidate decode the tracker uses,
the shared-candidate numerical gradient, the split-gradient row gather's
backward against jax.grad, the top-k tie rule (exact), and the lset-less
path through the cell-table probe (both `weighted_first` values, the fused
decode route on and off, `query_sdf_and_grad`, the two numerical
gradients) and through the brick probe."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jnpm
from pin_slam_tpu.models.decoder import init_mlp_params as j_init_mlp
from pin_slam_tpu.ops import knn_join as jk
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.models import neural_points as tnpm
from pin_slam_tpu_torch.ops import knn_join as tkj
from pin_slam_tpu_torch.slam import map_query as tmq

jax.config.update("jax_default_matmul_precision", "highest")
RES, F = 0.4, 8


def _cfg(cls):
    c = cls()
    c.voxel_size_m = RES
    c.probe_mode = "join"
    return c.finalize()


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def world():
    rng = np.random.RandomState(0)
    n = 5000
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.rand(n, 2) * 16 - 8
    p[:, 2] = 0.4 * np.sin(p[:, 0]) + 0.2 * np.cos(p[:, 1])
    js = jnpm.init_map_state(1 << 13, 1 << 15, F, color_on=False,
                             with_btable=False)
    js, _ = jnpm.insert_points(js, jnp.asarray(p), jnp.ones(n, bool), 0,
                               jnp.zeros(4), resolution=RES,
                               local_window_dist=50.0, maintain_btable=False)
    cnt = int(js.count)
    feats = np.zeros((js.capacity + 1, F), np.float32)
    feats[:cnt] = rng.randn(cnt, F).astype(np.float32) * 0.3
    quat = np.zeros((js.capacity + 1, 4), np.float32)
    quat[:, 0] = 1.0
    q = rng.randn(cnt, 4).astype(np.float32) * [1, 0.1, 0.1, 0.1]
    quat[:cnt] = q / np.linalg.norm(q, axis=1, keepdims=True)
    js = js.replace(geo_features=jnp.asarray(feats),
                    orientations=jnp.asarray(quat),
                    certainty=jnp.asarray(rng.rand(js.capacity + 1)
                                          .astype(np.float32)))
    mlp = j_init_mlp(jax.random.PRNGKey(3), F + 3, 64, 1, 1)
    mlp_np = {"w": [np.asarray(w) for w in mlp["w"]],
              "b": [np.asarray(b) for b in mlp["b"]]}
    qpts = p[rng.randint(0, n, 900)] + rng.randn(900, 3).astype(
        np.float32) * 0.15
    return js, mlp, mlp_np, qpts


def _sets(js, with_quat):
    m = jnp.arange(js.capacity) < js.count
    jls = jk.build_local_set(js.positions, m, RES, 4096,
                             certainty=js.certainty,
                             orientations=js.orientations if with_quat
                             else None)
    tls = tkj.build_local_set(
        _t(js.positions), _t(m), RES, 4096, certainty=_t(js.certainty),
        orientations=_t(js.orientations) if with_quat else None)
    return jls, tls


def test_query_params_match():
    jq = jmq.make_query_params(_cfg(JConfig))
    tq = tmq.make_query_params(_cfg(TConfig))
    for f in ("offsets", "resolution", "nn_k", "max_dist2", "sdf_scale",
              "weighted_first", "idw_index", "join_max_dist2", "probe_mode"):
        assert getattr(tq, f) == getattr(jq, f), f
    np.testing.assert_array_equal(tq.offsets_np, jq.offsets_np)


@pytest.mark.parametrize("with_quat", [False, True])
def test_query_decode_sdf_and_grad(world, with_quat):
    js, mlp, mlp_np, qpts = world
    jls, tls = _sets(js, with_quat)
    jqp = jmq.make_query_params(_cfg(JConfig))
    tqp = tmq.make_query_params(_cfg(TConfig))
    anchor = np.array([0.5, -0.25, 0.1], np.float32)
    qa = qpts - anchor
    jf = js.geo_features[jls.gidx]

    def f(p):
        o = jmq.query_decode(None, jf, mlp, p, jqp, lset=jls,
                             anchor=jnp.asarray(anchor))
        return jnp.sum(o.sdf), o

    jg, jo = jax.grad(f, has_aux=True)(jnp.asarray(qa))
    tmlp = convert.mlp_from_numpy(mlp_np, device="cpu")
    p = _t(qa).requires_grad_(True)
    to = tmq.query_decode(_t(jf), tmlp, p, tqp, lset=tls, anchor=_t(anchor))
    (tg,) = torch.autograd.grad(to.sdf.sum(), p)
    np.testing.assert_array_equal(to.nn_count.numpy(), np.asarray(jo.nn_count))
    np.testing.assert_allclose(to.sdf.detach().numpy(), np.asarray(jo.sdf),
                               atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(to.certainty.detach().numpy(),
                               np.asarray(jo.certainty), atol=1e-5)


@pytest.mark.parametrize("with_quat,weighted_first", [
    (False, True), (True, True), (False, False)])
def test_decode_sdf_candidates(world, with_quat, weighted_first):
    """The tracker's cached-candidate decode: k=12 candidates re-ranked to
    the exact top-6 at a moved pose, pre-gathered packed rows."""
    js, mlp, mlp_np, qpts = world
    jls, tls = _sets(js, with_quat)
    jqp = jmq.make_query_params(_cfg(JConfig))._replace(
        weighted_first=weighted_first)
    tqp = tmq.make_query_params(_cfg(TConfig))._replace(
        weighted_first=weighted_first)
    jf = js.geo_features[jls.gidx]
    jqn = jnpm.query_neighbors_join(None, jnp.asarray(qpts), jls, nn_k=12,
                                    max_dist2=jqp.join_max_dist2,
                                    resolution=RES)
    tqn = tkj_query(tls, qpts, tqp)
    np.testing.assert_array_equal(tqn.idx.numpy(), np.asarray(jqn.idx))
    moved = qpts + np.array([0.03, -0.02, 0.01], np.float32)
    jpack = jmq.pack_lset_rows(jls, jf)
    jrows = jpack[jnp.where(jqn.valid, jqn.idx, jls.cap)]
    tpack = tmq.pack_lset_rows(tls, _t(jf))
    trows = tpack[torch.where(tqn.valid, tqn.idx,
                              torch.full_like(tqn.idx, tls.cap))]

    def f(p):
        s, nn, std = jmq.decode_sdf_candidates(
            jls, jf, mlp, p, jqn.idx, jqn.valid, jqp, rows=jrows,
            with_std=not weighted_first)
        return jnp.sum(s), (s, nn, std)

    jg, (js_, jnn, jstd) = jax.grad(f, has_aux=True)(jnp.asarray(moved))
    p = _t(moved).requires_grad_(True)
    ts_, tnn, tstd = tmq.decode_sdf_candidates(
        tls, convert.mlp_from_numpy(mlp_np, device="cpu"), p, tqn.idx,
        tqn.valid, tqp, trows, with_std=not weighted_first)
    (tg,) = torch.autograd.grad(ts_.sum(), p)
    np.testing.assert_array_equal(tnn.numpy(), np.asarray(jnn))
    np.testing.assert_allclose(ts_.detach().numpy(), np.asarray(js_),
                               atol=1e-5, rtol=1e-5)
    if not weighted_first:
        np.testing.assert_allclose(tstd.detach().numpy(), np.asarray(jstd),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


def tkj_query(tls, q, tqp, k=12):
    return tnpm.query_neighbors_join(_t(q), tls, nn_k=k,
                                     max_dist2=tqp.join_max_dist2,
                                     resolution=RES)


def test_gather_rows_splitgrad_backward():
    rng = np.random.RandomState(4)
    nd = rng.randn(65, 3).astype(np.float32)
    fe = rng.randn(65, F).astype(np.float32)
    idx = rng.randint(0, 65, (300, 6))
    ct = rng.randn(300, 6, F).astype(np.float32)
    ct_nd = rng.randn(300, 6, 3).astype(np.float32)

    def jl(feats):
        a, b = jmq.gather_rows_splitgrad(jnp.asarray(nd), feats,
                                         jnp.asarray(idx))
        return jnp.sum(b * ct) + jnp.sum(jax.lax.stop_gradient(a) * ct_nd)

    jg = jax.grad(jl)(jnp.asarray(fe))
    tf = _t(fe).requires_grad_(True)
    a, b = tmq.gather_rows_splitgrad(_t(nd), tf, _t(idx))
    np.testing.assert_array_equal(a.detach().numpy(), nd[idx])
    np.testing.assert_array_equal(b.detach().numpy(), fe[idx])
    ((b * _t(ct)).sum() + (a * _t(ct_nd)).sum()).backward()
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jg), atol=1e-5)


@pytest.mark.parametrize("cached", [True, False])
def test_numerical_grad_shared_join(world, cached):
    """Eikonal gradient from shared candidates (cached, or one k=12 probe),
    and its backward into the features (through the split-gradient gather
    when cached)."""
    js, mlp, mlp_np, qpts = world
    jls, tls = _sets(js, False)
    jqp = jmq.make_query_params(_cfg(JConfig))
    tqp = tmq.make_query_params(_cfg(TConfig))
    jf = js.geo_features[jls.gidx]
    jqn = jnpm.query_neighbors_join(None, jnp.asarray(qpts), jls, nn_k=8,
                                    max_dist2=jqp.join_max_dist2,
                                    resolution=RES)
    tqn = tkj_query(tls, qpts, tqp, k=8)
    eps = RES * 0.2

    def jl(feats):
        g = jmq.numerical_grad_shared_join(
            jls, feats, mlp, jnp.asarray(qpts), eps, jqp,
            cand=(jqn.idx, jqn.valid) if cached else None,
            cand_pack=(jmq.pack_lset_nodiff(jls), feats) if cached else None)
        return jnp.sum(g ** 2), g

    jgf, jg = jax.grad(jl, has_aux=True)(jf)
    tf = _t(jf).requires_grad_(True)
    tg = tmq.numerical_grad_shared_join(
        tls, tf, convert.mlp_from_numpy(mlp_np, device="cpu"), _t(qpts),
        eps, tqp,
        cand=(tqn.idx, tqn.valid) if cached else None,
        cand_pack=(tmq.pack_lset_nodiff(tls), tf) if cached else None)
    (tg ** 2).sum().backward()
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), atol=1e-4,
                               rtol=1e-4)


def test_topk_select_mask_ties():
    rng = np.random.RandomState(5)
    d = rng.randint(0, 4, (500, 12)).astype(np.float32)
    d[:, 5] = 9e3
    for k in (1, 6, 11):
        np.testing.assert_array_equal(
            tmq.topk_select_mask(_t(d), k).numpy(),
            np.asarray(jmq.topk_select_mask(jnp.asarray(d), k)))


# ---------------------------------------------------------------- lset-less


def _tstate(js):
    return convert.from_jax(None, {f: np.array(getattr(js, f))
                                   for f in convert.STATE_FIELDS},
                            device="cpu")[1]


def _qps(weighted_first):
    return (jmq.make_query_params(_cfg(JConfig))._replace(
                weighted_first=weighted_first),
            tmq.make_query_params(_cfg(TConfig))._replace(
                weighted_first=weighted_first))


def test_probe_modes(world):
    """cells, auto (join) and brick resolve as named; an lset-less
    query_decode under `brick` probes the brick cache and answers as the
    JAX package's jitted one (both caches rebuilt from the same map): the
    same neighbours and nn_count, the SDF to 1e-5."""
    c = _cfg(TConfig)
    c.probe_mode = "cells"
    assert tmq.make_query_params(c).probe_mode == "cells"
    c.probe_mode = "auto"
    assert tmq.make_query_params(c).probe_mode == "join"
    c.probe_mode = "brick"
    tqp = tmq.make_query_params(c)
    assert tqp.probe_mode == "brick"
    with pytest.raises(ValueError, match="local set or a map state"):
        tmq.query_decode(torch.zeros(3, F), None, torch.zeros(2, 3),
                         tmq.make_query_params(_cfg(TConfig)))

    js, mlp, mlp_np, qpts = world
    jc = _cfg(JConfig)
    jc.probe_mode = "brick"
    jqp = jmq.make_query_params(jc)
    nb = jnpm._brick_count(js.table_size)
    jb = jax.jit(lambda s: jnpm.rebuild_probe_cache(
        s.replace(btable=jnpm._empty_btable(nb)), RES))(js)
    ts = tnpm.rebuild_probe_cache(
        _tstate(js).replace(btable=tnpm._empty_btable(nb)), RES)
    jo = jax.jit(lambda s, q: jmq.query_decode(s, s.geo_features, mlp, q,
                                               jqp))(jb, jnp.asarray(qpts))
    to = tmq.query_decode(ts.geo_features,
                          convert.mlp_from_numpy(mlp_np, device="cpu"),
                          _t(qpts), tqp, state=ts)
    assert np.asarray(jo.nn_count).max() >= 6
    np.testing.assert_array_equal(to.nn_count.numpy(),
                                  np.asarray(jo.nn_count))
    np.testing.assert_array_equal(to.neighbors.idx.numpy(),
                                  np.asarray(jo.neighbors.idx))
    np.testing.assert_allclose(to.sdf.detach().numpy(), np.asarray(jo.sdf),
                               atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("weighted_first,filtered", [
    (True, False), (False, False), (True, True), (False, True)])
def test_lsetless_query_decode(world, weighted_first, filtered):
    """No local set: the cell-table probe over the whole map (a "join"
    configuration maps to "cells"), positions / orientations / certainty
    from the state, features from the full [C+1, F] array; with a
    LocalFilter, the time and radius filters of the probe."""
    js, mlp, mlp_np, qpts = world
    ts = _tstate(js)
    jqp, tqp = _qps(weighted_first)
    assert tqp.probe_mode == "join"
    anchor = np.array([0.5, -0.25, 0.1], np.float32)
    qa = qpts - anchor
    jlf = tlf = None
    if filtered:
        travel = np.arange(4, dtype=np.float32) * 3.0
        sp = np.array([1.0, 0.5, 0.0], np.float32) - anchor
        jlf = jmq.LocalFilter(jnp.asarray(travel), jnp.int32(2), 50.0,
                              sensor_pos=jnp.asarray(sp),
                              local_map_radius=5.0)
        tlf = tmq.LocalFilter(_t(travel), 2, 50.0, sensor_pos=_t(sp),
                              local_map_radius=5.0)

    def f(p):
        o = jmq.query_decode(js, js.geo_features, mlp, p, jqp,
                             anchor=jnp.asarray(anchor), lf=jlf,
                             with_std=True)
        return jnp.sum(o.sdf), o

    jg, jo = jax.grad(f, has_aux=True)(jnp.asarray(qa))
    tmlp = convert.mlp_from_numpy(mlp_np, device="cpu")
    p = _t(qa).requires_grad_(True)
    to = tmq.query_decode(ts.geo_features, tmlp, p, tqp, state=ts,
                          anchor=_t(anchor), lf=tlf, with_std=True)
    (tg,) = torch.autograd.grad(to.sdf.sum(), p)
    jn = np.asarray(jo.nn_count)
    assert jn.max() >= 6 and (not filtered or jn.min() == 0)
    np.testing.assert_array_equal(to.nn_count.numpy(), jn)
    np.testing.assert_array_equal(to.neighbors.idx.numpy(),
                                  np.asarray(jo.neighbors.idx))
    for a, b in ((to.sdf, jo.sdf), (to.sdf_std, jo.sdf_std),
                 (to.certainty, jo.certainty), (to.weights, jo.weights)):
        np.testing.assert_allclose(a.detach().numpy(), np.asarray(b),
                                   atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("weighted_first", [True, False])
def test_fused_route_gives_the_same_sdf(world, weighted_first):
    """fused=True (the mesher's forward-only route) against fused=False:
    on the CPU the fused wrapper runs its plain version, so the SDF agrees
    to the float32 rounding of a differently ordered sum (1e-6). With a
    decoder the kernel does not compute, with the std, or with
    weighted_first=True the call raises: the plain decode is never taken
    in the kernel's place."""
    js, mlp, mlp_np, qpts = world
    ts = _tstate(js)
    _, tqp = _qps(weighted_first)
    tmlp = convert.mlp_from_numpy(mlp_np, device="cpu")
    q = _t(qpts)
    with torch.no_grad():
        a = tmq.query_decode(ts.geo_features, tmlp, q, tqp, state=ts)
        if weighted_first:
            with pytest.raises(ValueError, match="weighted_first"):
                tmq.query_decode(ts.geo_features, tmlp, q, tqp, state=ts,
                                 fused=True)
            return
        b = tmq.query_decode(ts.geo_features, tmlp, q, tqp, state=ts,
                             fused=True)
        np.testing.assert_allclose(b.sdf.numpy(), a.sdf.numpy(), atol=1e-6)
        np.testing.assert_array_equal(b.nn_count.numpy(), a.nn_count.numpy())
        assert b.sdf_std is None
        with pytest.raises(ValueError, match="with_std"):
            tmq.query_decode(ts.geo_features, tmlp, q, tqp, state=ts,
                             fused=True, with_std=True)
        lqp = tqp._replace(mlp_leaky_relu=True)
        with pytest.raises(ValueError, match="one-hidden-layer"):
            tmq.query_decode(ts.geo_features, tmlp, q, lqp, state=ts,
                             fused=True)


@pytest.mark.parametrize("weighted_first", [True, False])
def test_query_sdf_and_grad(world, weighted_first):
    js, mlp, mlp_np, qpts = world
    ts = _tstate(js)
    jqp, tqp = _qps(weighted_first)
    js_, jg, jo = jmq.query_sdf_and_grad(js, js.geo_features, mlp,
                                         jnp.asarray(qpts), jqp)
    with torch.no_grad():       # the function turns autograd on itself
        ts_, tg, to = tmq.query_sdf_and_grad(
            ts.geo_features, convert.mlp_from_numpy(mlp_np, device="cpu"),
            _t(qpts), tqp, state=ts)
    np.testing.assert_array_equal(to.nn_count.numpy(),
                                  np.asarray(jo.nn_count))
    np.testing.assert_allclose(ts_.numpy(), np.asarray(js_), atol=1e-5,
                               rtol=1e-5)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize("weighted_first", [True, False])
def test_query_sdf_numerical_grad(world, weighted_first):
    """Six full queries; tolerance 1e-4: the central difference divides a
    1e-6 SDF difference by 2 eps = 0.16."""
    js, mlp, mlp_np, qpts = world
    ts = _tstate(js)
    jqp, tqp = _qps(weighted_first)
    eps = RES * 0.2
    q = qpts[:300]

    def jl(feats):
        g = jmq.query_sdf_numerical_grad(js, feats, mlp, jnp.asarray(q),
                                         eps, jqp)
        return jnp.sum(g ** 2), g

    jgf, jg = jax.grad(jl, has_aux=True)(js.geo_features)
    tf = ts.geo_features.clone().requires_grad_(True)
    tg = tmq.query_sdf_numerical_grad(
        tf, convert.mlp_from_numpy(mlp_np, device="cpu"), _t(q), eps, tqp,
        state=ts)
    (tg ** 2).sum().backward()
    np.testing.assert_allclose(tg.detach().numpy(), np.asarray(jg),
                               atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(tf.grad.numpy(), np.asarray(jgf), atol=1e-4,
                               rtol=1e-4)


@pytest.mark.parametrize("weighted_first", [True, False])
def test_numerical_grad_from_neighbors(world, weighted_first):
    js, mlp, mlp_np, qpts = world
    ts = _tstate(js)
    jqp, tqp = _qps(weighted_first)
    eps = RES * 0.2
    q = qpts[:300]
    jo = jmq.query_decode(js, js.geo_features, mlp, jnp.asarray(q), jqp)
    tmlp = convert.mlp_from_numpy(mlp_np, device="cpu")
    to = tmq.query_decode(ts.geo_features, tmlp, _t(q), tqp, state=ts)
    jg = jmq.numerical_grad_from_neighbors(js, js.geo_features, mlp,
                                           jnp.asarray(q), jo.neighbors, eps,
                                           jqp)
    tg = tmq.numerical_grad_from_neighbors(ts, ts.geo_features, tmlp, _t(q),
                                           to.neighbors, eps, tqp)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), atol=1e-4,
                               rtol=1e-4)
