"""The port's neural point map (pin_slam_tpu_torch.models.neural_points)
against the JAX package on identical inputs: insert counts and every map
row 1:1, the local-map mask, the join neighbor query, prune + rehash
(all exact), IDW weights (<= 1e-6), and the cell-table probe (idx, valid,
nn_count equal, d2 <= 1e-6)."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from pin_slam_tpu.models import neural_points as jnpm
from pin_slam_tpu.ops import hash3d as jh
from pin_slam_tpu.ops import knn_join as jk
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.models import neural_points as tnpm
from pin_slam_tpu_torch.ops import hash3d as th
from pin_slam_tpu_torch.ops import knn_join as tkj

C, B, F, RES = 8192, 1 << 15, 8, 0.4
FIELDS = ("positions", "orientations", "geo_features", "ts_create",
          "ts_update", "certainty", "count", "table")


def _np_state(js):
    return {f: np.array(getattr(js, f)) for f in FIELDS}


def _assert_same(ts, js):
    for f in FIELDS:
        np.testing.assert_array_equal(
            getattr(ts, f).numpy(), np.asarray(getattr(js, f)).astype(
                getattr(ts, f).numpy().dtype), err_msg=f)


def _scene(seed, n=6000, shift=0.0):
    rng = np.random.RandomState(seed)
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.rand(n, 2) * 24 - 12 + shift
    p[:, 2] = 0.3 * np.sin(p[:, 0]) + rng.randn(n) * 0.02
    m = rng.rand(n) < 0.95
    return p, m


def _insert_both(js, ts, p, m, cur_ts, travel, **kw):
    js, jr = jnpm.insert_points(
        js, jnp.asarray(p), jnp.asarray(m), cur_ts, jnp.asarray(travel),
        resolution=RES, local_window_dist=20.0, maintain_btable=False, **kw)
    ts, tr = tnpm.insert_points(
        ts, torch.as_tensor(p), torch.as_tensor(m), cur_ts,
        torch.as_tensor(travel), resolution=RES, local_window_dist=20.0,
        **kw)
    assert float(tr) == pytest.approx(float(jr), abs=1e-7)
    return js, ts


@pytest.fixture(scope="module")
def maps():
    """Three inserts: a fresh scene, a shifted re-observation far along the
    travel window (re-observation rule), and a capped reboot insert."""
    js = jnpm.init_map_state(C, B, F, color_on=False, with_btable=False)
    ts = tnpm.init_map_state(C, B, F)
    travel = np.cumsum(np.full(16, 3.0)).astype(np.float32)
    travel[0] = 0.0
    p, m = _scene(0)
    js, ts = _insert_both(js, ts, p, m, 0, travel)
    p, m = _scene(1, shift=1.3)
    js, ts = _insert_both(js, ts, p, m, 9, travel)
    p, m = _scene(2, shift=-0.7)
    js, ts = _insert_both(js, ts, p, m, 11, travel, force_all_new=True,
                          insert_cap=1024)
    return js, ts, travel


def test_insert_points_rows_match(maps):
    js, ts, _ = maps
    assert int(ts.count) == int(js.count) > 1000
    _assert_same(ts, js)


def test_insert_into_full_map():
    js = jnpm.init_map_state(512, 1 << 12, F, color_on=False,
                             with_btable=False)
    ts = tnpm.init_map_state(512, 1 << 12, F)
    travel = np.zeros(4, np.float32)
    for seed in range(3):
        p, m = _scene(seed, n=1500)
        js, ts = _insert_both(js, ts, p, m, seed, travel)
    assert int(ts.count) == 512
    _assert_same(ts, js)


def test_convert_roundtrip(maps):
    js, _, _ = maps
    _, ts = convert.from_jax(None, _np_state(js))
    _assert_same(ts, js)


@pytest.mark.parametrize("cur_ts,radius", [(9, 0.0), (11, 8.0)])
def test_local_map_mask(maps, cur_ts, radius):
    js, ts, travel = maps
    sp = np.array([0.5, -1.0, 0.0], np.float32)
    jm = jnpm.local_map_mask(
        js, jnp.asarray(travel), cur_ts, 20.0,
        sensor_pos=jnp.asarray(sp) if radius else None,
        local_map_radius=radius, reboot_ts=1)
    tm = tnpm.local_map_mask(
        ts, torch.as_tensor(travel), cur_ts, 20.0,
        sensor_pos=torch.as_tensor(sp) if radius else None,
        local_map_radius=radius, reboot_ts=1)
    np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))


@pytest.mark.parametrize("k,local_ids", [(6, True), (8, False), (12, True)])
def test_query_neighbors_join(maps, k, local_ids):
    js, ts, travel = maps
    jm = jnpm.local_map_mask(js, jnp.asarray(travel), 11, 20.0)
    tm = tnpm.local_map_mask(ts, torch.as_tensor(travel), 11, 20.0)
    jls = jk.build_local_set(js.positions, jm, RES, 4096)
    tls = tkj.build_local_set(ts.positions, tm, RES, 4096)
    q, _ = _scene(5, n=700, shift=0.2)
    jq = jnpm.query_neighbors_join(js, jnp.asarray(q), jls, nn_k=k,
                                   max_dist2=1.0, resolution=RES,
                                   local_ids=local_ids)
    tq = tnpm.query_neighbors_join(torch.as_tensor(q), tls, nn_k=k,
                                   max_dist2=1.0, resolution=RES,
                                   capacity=C, local_ids=local_ids)
    for f in ("idx", "dist2", "valid", "nn_count"):
        np.testing.assert_array_equal(getattr(tq, f).numpy(),
                                      np.asarray(getattr(jq, f)), err_msg=f)
    np.testing.assert_allclose(tnpm.idw_weights(tq).numpy(),
                               np.asarray(jnpm.idw_weights(jq)), atol=1e-6)
    if not local_ids:
        # training-mode side effect on the global map rows
        qts = np.random.RandomState(k).randint(0, 12, q.shape[0])
        js2 = jnpm.accumulate_certainty(js, jq, jnpm.idw_weights(jq),
                                        jnp.asarray(qts))
        ts2 = tnpm.accumulate_certainty(
            convert.from_jax(None, _np_state(js))[1], tq,
            tnpm.idw_weights(tq), torch.as_tensor(qts))
        np.testing.assert_allclose(ts2.certainty.numpy(),
                                   np.asarray(js2.certainty), atol=1e-5)
        np.testing.assert_array_equal(ts2.ts_update.numpy(),
                                      np.asarray(js2.ts_update))


def test_prune_and_rehash(maps):
    js, _, travel = maps
    rng = np.random.RandomState(7)
    s = _np_state(js)
    n = int(s["count"])
    s["certainty"][:n] = rng.rand(n).astype(np.float32) * 6
    s["ts_update"][:n] = rng.randint(0, 12, n)
    js = js.replace(certainty=jnp.asarray(s["certainty"]),
                    ts_update=jnp.asarray(s["ts_update"]))
    _, ts = convert.from_jax(None, s)
    js2, jn = jnpm.prune_map(js, 11, jnp.asarray(travel),
                             prune_certainty_thre=3.0, local_window_dist=10.0)
    ts2, tn = tnpm.prune_map(ts, 11, torch.as_tensor(travel),
                             prune_certainty_thre=3.0, local_window_dist=10.0)
    assert int(tn) == int(jn) > 0
    _assert_same(ts2, js2)
    for use_mid in (False, True):
        j3 = jnpm.rehash(js2, 11, resolution=RES, use_mid_ts=use_mid)
        t3 = tnpm.rehash(ts2, 11, resolution=RES, use_mid_ts=use_mid)
        np.testing.assert_array_equal(t3.table.numpy(), np.asarray(j3.table))


@pytest.mark.parametrize("cells,alpha", [(2, 0.2), (1, 0.5), (2, 0.5),
                                         (3, 0.0)])
def test_neighbor_offsets(cells, alpha):
    to = th.neighbor_offsets(cells, alpha)
    jo = jh.neighbor_offsets(cells, alpha)
    assert to.dtype == jo.dtype
    np.testing.assert_array_equal(to, jo)
    assert th.neighbor_offsets_max_r2(cells, alpha) == int(
        (jo.astype(np.int64) ** 2).sum(-1).max())


def _cells_both(js, ts, q, k, **kw):
    offs = jh.neighbor_offsets(2, 0.2)
    jkw = {a: (jnp.asarray(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()}
    tkw = {a: (torch.as_tensor(v) if isinstance(v, np.ndarray) else v)
           for a, v in kw.items()}
    jq = jnpm.query_neighbors(js, jnp.asarray(q), offsets=offs,
                              resolution=RES, nn_k=k,
                              max_dist2=jh.max_valid_dist2(2, RES),
                              probe_mode="cells", **jkw)
    tq = tnpm.query_neighbors(ts, torch.as_tensor(q),
                              offsets=th.neighbor_offsets(2, 0.2),
                              resolution=RES, nn_k=k,
                              max_dist2=th.max_valid_dist2(2, RES),
                              probe_mode="cells", **tkw)
    return jq, tq


def _assert_same_neighbors(tq, jq):
    """Distances are float32 sums of three squares, which XLA and torch
    may contract differently (<= 1e-6); the ranking they give is the same
    on these inputs, so indices, validity and counts are equal. Equal
    distances would keep the lower offset column on both sides (a stable
    sort here, lax.top_k there)."""
    np.testing.assert_array_equal(tq.idx.numpy(), np.asarray(jq.idx))
    np.testing.assert_array_equal(tq.valid.numpy(), np.asarray(jq.valid))
    np.testing.assert_array_equal(tq.nn_count.numpy(),
                                  np.asarray(jq.nn_count))
    np.testing.assert_allclose(tq.dist2.numpy(), np.asarray(jq.dist2),
                               atol=1e-6, rtol=1e-6)
    np.testing.assert_allclose(tnpm.idw_weights(tq).numpy(),
                               np.asarray(jnpm.idw_weights(jq)), atol=1e-6)


@pytest.mark.parametrize("k", [1, 6, 8])
def test_query_neighbors_cells(maps, k):
    js, ts, _ = maps
    q, _ = _scene(5, n=900, shift=0.2)
    jq, tq = _cells_both(js, ts, q, k)
    assert int(tq.nn_count.min()) >= 0 and int(tq.nn_count.max()) > k
    _assert_same_neighbors(tq, jq)


@pytest.mark.parametrize("cur_ts,window,reboot,use_mid,radius", [
    (11, 20.0, 0, False, 0.0), (11, 5.0, 0, False, 0.0),
    (11, 20.0, 9, False, 0.0), (11, 8.0, 0, True, 0.0),
    (9, 20.0, 0, False, 8.0), (11, 5.0, 1, True, 6.0)])
def test_query_neighbors_cells_filters(maps, cur_ts, window, reboot, use_mid,
                                       radius):
    js, ts, travel = maps
    # give the mid-timestamp rule something to move
    upd = np.array(js.ts_update)
    upd[: int(js.count)] = np.random.RandomState(3).randint(
        0, 12, int(js.count))
    js = js.replace(ts_update=jnp.asarray(upd))
    ts = ts.replace(ts_update=torch.as_tensor(upd))
    q, _ = _scene(6, n=900, shift=-0.3)
    kw = dict(time_filter=True, travel_dist=travel, cur_ts=cur_ts,
              local_window_dist=window, reboot_ts=reboot, use_mid_ts=use_mid)
    if radius:
        kw.update(radius_filter=True, local_map_radius=radius,
                  sensor_pos=np.array([0.5, -1.0, 0.0], np.float32))
    jq, tq = _cells_both(js, ts, q, 6, **kw)
    jall, _ = _cells_both(js, ts, q, 6)
    # the filters cut something, and leave something
    assert 0 < int(np.asarray(jq.nn_count).sum()) < int(
        np.asarray(jall.nn_count).sum())
    _assert_same_neighbors(tq, jq)


def test_query_neighbors_cells_empty_map():
    js = jnpm.init_map_state(C, B, F, color_on=False, with_btable=False)
    ts = tnpm.init_map_state(C, B, F)
    q, _ = _scene(7, n=200)
    jq, tq = _cells_both(js, ts, q, 6)
    assert int(tq.nn_count.sum()) == 0 and not bool(tq.valid.any())
    assert bool((tq.idx == C).all())
    w = tnpm.idw_weights(tq)
    assert bool(torch.isfinite(w).all()) and float(w.abs().sum()) == 0.0
    _assert_same_neighbors(tq, jq)


def test_query_neighbors_brick_is_refused(maps):
    _, ts, _ = maps
    with pytest.raises(NotImplementedError, match="part B"):
        tnpm.query_neighbors(ts, torch.zeros(4, 3),
                             offsets=th.neighbor_offsets(2, 0.2),
                             resolution=RES, nn_k=6, max_dist2=1.0,
                             probe_mode="brick")
