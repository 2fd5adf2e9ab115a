"""The port's brick cache and brick probe (part B of
pin_slam_tpu_torch.models.neural_points) against the JAX package on
identical inputs, on the CPU:

* after three inserts (a fresh scene, a re-observation along the travel
  window, a capped reboot insert) and after a rehash, the brick cache
  `btable` is bit-equal to the JAX one, dump brick included;
* the alias rule: records aimed at one brick slot (two bricks with one
  brick hash, or one cell written twice) resolve as XLA's CPU scatter does,
  the last record in row order wins; the test's table is small enough that
  the scene's bricks alias;
* the brick probe gives the same idx / valid / nn_count and ranking dist2,
  bit for bit, as the JAX package's jitted probe (whose distances XLA
  contracts into FMAs), plain and with the time filter, the radius filter
  and `use_mid_ts`; chunked queries equal unchunked ones;
* a map saved by either package loads into the other with the same brick
  cache, and `convert` carries a JAX cache across.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jnpm
from pin_slam_tpu.models.decoder import init_mlp_params as j_init_mlp
from pin_slam_tpu.ops import hash3d as jh
from pin_slam_tpu.utils import map_io as jio
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.models import neural_points as tnpm
from pin_slam_tpu_torch.utils import map_io as tio

# a 2^14 table keeps 1024 bricks: the scene's bricks alias
C, B, F, RES = 8192, 1 << 14, 8, 0.4
OFFS = jh.neighbor_offsets(2, 0.2)
MAX_D2 = jh.max_valid_dist2(2, RES)


def _scene(seed, n=6000, shift=0.0):
    rng = np.random.RandomState(seed)
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.rand(n, 2) * 24 - 12 + shift
    p[:, 2] = 0.3 * np.sin(p[:, 0]) + rng.randn(n) * 0.02
    m = rng.rand(n) < 0.95
    return p, m


def _j_insert(js, p, m, cur_ts, travel, force_all_new=False,
              insert_cap=1 << 16):
    """The JAX insert, jitted as the JAX system runs it."""
    f = jax.jit(lambda s, pp, mm, t, tr, fa: jnpm.insert_points(
        s, pp, mm, t, tr, resolution=RES, local_window_dist=20.0,
        force_all_new=fa, insert_cap=insert_cap))
    return f(js, jnp.asarray(p), jnp.asarray(m), jnp.int32(cur_ts),
             jnp.asarray(travel), jnp.bool_(force_all_new))[0]


def _t_insert(ts, p, m, cur_ts, travel, force_all_new=False,
              insert_cap=1 << 16):
    return tnpm.insert_points(
        ts, torch.as_tensor(p), torch.as_tensor(m), cur_ts,
        torch.as_tensor(travel), resolution=RES, local_window_dist=20.0,
        force_all_new=force_all_new, insert_cap=insert_cap)[0]


def _same_btable(ts, js):
    np.testing.assert_array_equal(ts.btable.numpy(), np.asarray(js.btable))


@pytest.fixture(scope="module")
def maps():
    js = jnpm.init_map_state(C, B, F, color_on=False, with_btable=True)
    ts = tnpm.init_map_state(C, B, F, device="cpu")
    travel = np.cumsum(np.full(16, 3.0)).astype(np.float32)
    travel[0] = 0.0
    for seed, shift, cur_ts, kw in ((0, 0.0, 0, {}), (1, 1.3, 9, {}),
                                    (2, -0.7, 11, dict(force_all_new=True,
                                                       insert_cap=1024))):
        p, m = _scene(seed, shift=shift)
        js = _j_insert(js, p, m, cur_ts, travel, **kw)
        ts = _t_insert(ts, p, m, cur_ts, travel, **kw)
    # random update timestamps for the mid-timestamp window
    rng = np.random.RandomState(7)
    tsu = rng.randint(0, 16, C + 1).astype(np.int32)
    js = js.replace(ts_update=jnp.asarray(tsu))
    ts.ts_update.copy_(torch.as_tensor(tsu))
    return js, ts, travel


def test_btable_after_insert_matches(maps):
    js, ts, _ = maps
    assert ts.btable.shape == (B // 16 + 1, 64, 3)
    assert int(ts.count) == int(js.count) > 5000
    _same_btable(ts, js)
    # the scene's live cells alias in the brick hash, so the rule was used
    n = int(ts.count)
    grid = np.floor(ts.positions[:n].numpy() / np.float32(RES)).astype(
        np.int64)
    bricks = np.unique(grid >> 2, axis=0)
    hb = np.asarray(jh.hash_grid(jnp.asarray(bricks.astype(np.int32)),
                                 B // 16))
    assert len(np.unique(hb)) < len(bricks)


def test_brick_write_alias_rule():
    """Records aimed at one slot: the last in row order wins, as XLA's CPU
    scatter lets it (the JAX function, jitted, and a numpy replay agree)."""
    nb = 1024
    rng = np.random.RandomState(3)
    grid = rng.randint(-40, 40, (3000, 3)).astype(np.int32)
    grid[1000:1100] = grid[:100]          # the same cells written again
    idx = np.arange(3000, dtype=np.int32)
    tsv = rng.randint(0, 50, 3000).astype(np.int32)
    pos = ((grid + rng.rand(3000, 3)) * RES).astype(np.float32)
    mask = rng.rand(3000) < 0.9
    jb = jax.jit(lambda g, i, t, p, m: jnpm._brick_write(
        jnpm._empty_btable(nb), g, i, t, p, RES, m))(
        jnp.asarray(grid), jnp.asarray(idx), jnp.asarray(tsv),
        jnp.asarray(pos), jnp.asarray(mask))
    tb = tnpm._brick_write(
        tnpm._empty_btable(nb), torch.as_tensor(grid), torch.as_tensor(idx),
        torch.as_tensor(tsv), torch.as_tensor(pos), RES,
        torch.as_tensor(mask))
    np.testing.assert_array_equal(tb.numpy(), np.asarray(jb))
    # numpy replay of the rule: sequential writes, the last one stays
    hb = np.asarray(jh.hash_grid(jnp.asarray(grid >> 2), nb)).astype(
        np.int64)
    slot = (grid[:, 0] & 3) * 16 + (grid[:, 1] & 3) * 4 + (grid[:, 2] & 3)
    flat = np.where(mask, hb * 64 + slot, nb * 64)
    assert len(np.unique(flat)) < len(flat)
    want = np.full(((nb + 1) * 64, 3), -1, np.int32)
    for r in range(3000):
        want[flat[r], :2] = (idx[r], tsv[r])
    np.testing.assert_array_equal(tb.numpy().reshape(-1, 3)[:, :2],
                                  want[:, :2])


def test_btable_after_rehash_matches(maps):
    js, ts, _ = maps
    jr = jax.jit(lambda s: jnpm.rehash(s, 11, resolution=RES,
                                       use_mid_ts=True))(js)
    tr = tnpm.rehash(tnpm.MapState(**{k: v.clone() if torch.is_tensor(v)
                                      else v for k, v in vars(ts).items()}),
                     11, resolution=RES, use_mid_ts=True)
    np.testing.assert_array_equal(tr.table.numpy(),
                                  np.asarray(jr.table).astype(np.int64))
    _same_btable(tr, jr)


def _queries(seed=5, n=700):
    q, _ = _scene(seed, n=n, shift=0.2)
    rng = np.random.RandomState(seed)
    return (q + rng.randn(n, 3).astype(np.float32) * 0.3).astype(np.float32)


def _filter_kw(travel, time_f, radius_f, mid):
    jkw, tkw = {}, {}
    if time_f:
        jkw = dict(time_filter=True, travel_dist=jnp.asarray(travel),
                   cur_ts=11, local_window_dist=20.0, reboot_ts=1,
                   use_mid_ts=mid)
        tkw = dict(time_filter=True, travel_dist=torch.as_tensor(travel),
                   cur_ts=11, local_window_dist=20.0, reboot_ts=1,
                   use_mid_ts=mid)
    if radius_f:
        sp = np.array([1.0, -2.0, 0.1], np.float32)
        jkw.update(radius_filter=True, sensor_pos=jnp.asarray(sp),
                   local_map_radius=9.0)
        tkw.update(radius_filter=True, sensor_pos=torch.as_tensor(sp),
                   local_map_radius=9.0)
    return jkw, tkw


@pytest.mark.parametrize("time_f,radius_f,mid,k", [
    (False, False, False, 6), (True, False, False, 8),
    (False, True, False, 6), (True, True, True, 12)])
def test_query_neighbors_brick_matches(maps, time_f, radius_f, mid, k):
    js, ts, travel = maps
    q = _queries()
    jkw, tkw = _filter_kw(travel, time_f, radius_f, mid)
    arr = {k_: v for k_, v in jkw.items() if not isinstance(v, (bool, int,
                                                               float))}
    static = {k_: v for k_, v in jkw.items() if k_ not in arr}
    jq = jax.jit(lambda s, qq, a: jnpm.query_neighbors(
        s, qq, offsets=OFFS, resolution=RES, nn_k=k, max_dist2=MAX_D2,
        probe_mode="brick", **a, **static))(js, jnp.asarray(q), arr)
    tq = tnpm.query_neighbors(ts, torch.as_tensor(q), offsets=OFFS,
                              resolution=RES, nn_k=k, max_dist2=MAX_D2,
                              probe_mode="brick", **tkw)
    assert int(np.asarray(jq.nn_count).sum()) > 1000
    np.testing.assert_array_equal(tq.nn_count.numpy(),
                                  np.asarray(jq.nn_count))
    np.testing.assert_array_equal(tq.valid.numpy(), np.asarray(jq.valid))
    np.testing.assert_array_equal(tq.idx.numpy(),
                                  np.asarray(jq.idx).astype(np.int64))
    np.testing.assert_array_equal(tq.dist2.numpy(), np.asarray(jq.dist2))


def test_brick_queries_chunked_equal_unchunked(maps, monkeypatch):
    _, ts, travel = maps
    q = torch.as_tensor(_queries(n=1500))
    _, tkw = _filter_kw(travel, True, True, True)

    def run():
        return tnpm.query_neighbors(ts, q, offsets=OFFS, resolution=RES,
                                    nn_k=8, max_dist2=MAX_D2,
                                    probe_mode="brick", **tkw)

    whole = run()
    monkeypatch.setattr(tnpm, "BRICK_QUERY_CHUNK", 256)
    parts = run()
    for f in ("idx", "dist2", "valid", "nn_count"):
        assert torch.equal(getattr(parts, f), getattr(whole, f)), f


def test_brick_probe_needs_the_cache(maps):
    _, ts, _ = maps
    bare = ts.replace(btable=tnpm._empty_btable(0))
    with pytest.raises(ValueError, match="brick cache"):
        tnpm.query_neighbors(bare, torch.zeros(4, 3), offsets=OFFS,
                             resolution=RES, nn_k=6, max_dist2=MAX_D2,
                             probe_mode="brick")


def test_saved_maps_load_with_the_same_brick_cache(maps, tmp_path):
    """JAX save -> both loads, and port save -> both loads: the rebuilt
    brick caches are bit-equal to the JAX package's rebuilt the way its
    frame loop rebuilds them (jitted); `convert` carries the JAX cache.

    The JAX package's `load_implicit_map` rehashes eagerly, where XLA
    divides pos / res for the packed cell-local position; its jitted
    rehash multiplies by 1 / res in an FMA. The port packs as the jitted
    loop does, so against the eager load only packed positions differ, by
    one 1/256 step, on under 0.1 % of the records."""
    js, ts, _ = maps
    cfg_j, cfg_t = JConfig(), TConfig()
    for c in (cfg_j, cfg_t):
        c.voxel_size_m = RES
        c.buffer_size = B
        c.finalize()
    mlp = j_init_mlp(jax.random.PRNGKey(1), F + 3, 16, 1, 1)
    jpath, tpath = str(tmp_path / "j.npz"), str(tmp_path / "t.npz")
    jio.save_implicit_map(jpath, js, {"geo_mlp": mlp}, cfg_j)
    tio.save_implicit_map(tpath, ts, {"geo_mlp": convert.mlp_from_numpy(
        jax.tree.map(np.asarray, mlp), device="cpu")}, cfg_t)
    rehash = jax.jit(lambda s: jnpm.rehash(s, 0, resolution=RES,
                                           use_mid_ts=False))
    for path in (jpath, tpath):
        jl, _, _ = jio.load_implicit_map(path, capacity=C, with_btable=True)
        tl, _, _ = tio.load_implicit_map(path, capacity=C, with_btable=True,
                                         device="cpu")
        assert tnpm.has_btable(tl)
        _same_btable(tl, rehash(jl))
        eager, port = np.asarray(jl.btable), tl.btable.numpy()
        np.testing.assert_array_equal(port[..., :2], eager[..., :2])
        moved = port[..., 2] != eager[..., 2]
        assert moved.sum() <= 1e-3 * (eager[..., 0] >= 0).sum()
        bare, _, _ = tio.load_implicit_map(path, capacity=C,
                                           with_btable=False, device="cpu")
        assert not tnpm.has_btable(bare)
    st = {f: np.asarray(getattr(js, f)) for f in
          convert.STATE_FIELDS + convert.BRICK_FIELDS}
    _, carried = convert.from_jax(None, st, device="cpu")
    _same_btable(carried, js)
