"""The port's map save / load (pin_slam_tpu_torch.utils.map_io) against the
JAX package's, on one map with colour features, deformed orientations and
both decoders: a map saved by either package loads in the other with every
array bit-equal and the same hash table; the two files hold the same keys,
arrays and meta; and the SDF decoded from the reloaded map at 4096 random
points agrees to 1e-6 (float32 sums of a 64-unit decoder, outputs of
O(0.1))."""

import json

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jnpm
from pin_slam_tpu.models.decoder import init_mlp_params as j_init_mlp
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu.utils import map_io as jio
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.utils import map_io as tio

jax.config.update("jax_default_matmul_precision", "highest")
RES, F = 0.4, 8
SDF_ATOL = 1e-6
ARRAYS = ("positions", "orientations", "geo_features", "ts_create",
          "ts_update", "certainty", "color_features")


def _cfg(cls):
    c = cls()
    c.voxel_size_m = RES
    c.color_channel = 3
    c.color_on = True
    c.buffer_size = 1 << 15
    return c.finalize()


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A JAX map (3000 points of a wavy sheet, random features, colour
    features, timestamps, certainty and non-identity orientations) and
    decoders, saved by the JAX package."""
    rng = np.random.RandomState(0)
    n = 3000
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.rand(n, 2) * 16 - 8
    p[:, 2] = 0.4 * np.sin(p[:, 0]) + 0.2 * np.cos(p[:, 1])
    js = jnpm.init_map_state(1 << 12, 1 << 15, F, color_on=True,
                             with_btable=False)
    js, _ = jnpm.insert_points(js, jnp.asarray(p), jnp.ones(n, bool), 0,
                               jnp.zeros(4), resolution=RES,
                               local_window_dist=50.0, maintain_btable=False)
    c1 = js.capacity + 1
    quat = np.zeros((c1, 4), np.float32)
    quat[:, 0] = 1.0
    q = rng.randn(c1, 4).astype(np.float32) * [1, 0.1, 0.1, 0.1]
    cnt = int(js.count)
    quat[:cnt] = (q / np.linalg.norm(q, axis=1, keepdims=True))[:cnt]
    js = js.replace(
        geo_features=jnp.asarray(rng.randn(c1, F).astype(np.float32) * 0.3),
        color_features=jnp.asarray(rng.randn(c1, F).astype(np.float32)),
        orientations=jnp.asarray(quat),
        ts_create=jnp.asarray(rng.randint(0, 50, c1).astype(np.int32)),
        ts_update=jnp.asarray(rng.randint(50, 99, c1).astype(np.int32)),
        certainty=jnp.asarray(rng.rand(c1).astype(np.float32) * 9))
    params = {"geo_mlp": j_init_mlp(jax.random.PRNGKey(3), F + 3, 64, 1, 1),
              "color_mlp": j_init_mlp(jax.random.PRNGKey(4), F + 3, 64, 1,
                                      3),
              "geo_features": js.geo_features}
    root = tmp_path_factory.mktemp("map_io")
    path = str(root / "jax_map.npz")
    jio.save_implicit_map(path, js, params, _cfg(JConfig))
    qpts = p[rng.randint(0, n, 4096)] + rng.randn(4096, 3).astype(
        np.float32) * 0.2
    return root, path, qpts


def _npz(path):
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def _jax_sdf(state, mlps, qpts):
    qp = jmq.make_query_params(_cfg(JConfig))._replace(probe_mode="cells")
    out = jmq.query_decode(state, state.geo_features, mlps["geo_mlp"],
                           jnp.asarray(qpts), qp)
    return np.asarray(out.sdf), np.asarray(out.nn_count)


def _port_sdf(state, mlps, qpts):
    qp = tmq.make_query_params(_cfg(TConfig))
    with torch.no_grad():
        out = tmq.query_decode(state.geo_features, mlps["geo_mlp"],
                               torch.as_tensor(qpts), qp, state=state)
    return out.sdf.numpy(), out.nn_count.numpy()


def test_jax_map_loads_in_the_port_bit_equal(saved):
    _, path, _ = saved
    z = _npz(path)
    ts, tm, tmeta = tio.load_implicit_map(path, device="cpu")
    js, jm, jmeta = jio.load_implicit_map(path, with_btable=False)
    cnt = int(z["positions"].shape[0])
    assert int(ts.count) == cnt == int(js.count) and tmeta == jmeta
    assert ts.capacity == js.capacity
    for f in ARRAYS:
        got = getattr(ts, f)[:cnt].numpy()
        assert got.dtype == z[f].dtype, f
        np.testing.assert_array_equal(got, z[f][:cnt], err_msg=f)
        np.testing.assert_array_equal(got, np.asarray(getattr(js, f))[:cnt])
    # the rehashed table is the JAX package's
    np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))
    for name in ("geo_mlp", "color_mlp"):
        for kind in ("w", "b"):
            for a, b in zip(tm[name][kind], jm[name][kind]):
                np.testing.assert_array_equal(a.numpy(), np.asarray(b))


def test_port_map_loads_in_jax_with_the_same_file_contents(saved):
    """Each package reloads the JAX file and saves it again: the two files
    hold the same keys, arrays (dtype and bits) and meta, and the port's
    loads in JAX with the port's table."""
    root, path, _ = saved
    ts, tm, _ = tio.load_implicit_map(path, device="cpu")
    params = dict(tm, geo_features=ts.geo_features)
    out = str(root / "port_map.npz")
    tio.save_implicit_map(out, ts, params, _cfg(TConfig))
    js, jm, _ = jio.load_implicit_map(path, with_btable=False)
    ref = str(root / "jax_again.npz")
    jio.save_implicit_map(ref, js, dict(jm, geo_features=js.geo_features),
                          _cfg(JConfig))
    a, b = _npz(ref), _npz(out)
    assert sorted(a) == sorted(b)
    assert json.loads(bytes(a.pop("meta_json")).decode()) == \
        json.loads(bytes(b.pop("meta_json")).decode())
    for k in a:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)
    js, _, _ = jio.load_implicit_map(out, with_btable=False)
    np.testing.assert_array_equal(ts.table.numpy(), np.asarray(js.table))


def test_colour_features_round_trip(saved):
    """Colour features go JAX -> port -> JAX unchanged; the dump row and
    the rows past `count` stay zero."""
    root, path, _ = saved
    ts, tm, _ = tio.load_implicit_map(path, device="cpu")
    cnt = int(ts.count)
    assert not ts.color_features[cnt:].any()
    out = str(root / "port_map_colour.npz")
    tio.save_implicit_map(out, ts, dict(tm), _cfg(TConfig))
    js, _, _ = jio.load_implicit_map(out, with_btable=False)
    np.testing.assert_array_equal(np.asarray(js.color_features)[:cnt],
                                  _npz(path)["color_features"][:cnt])


def test_reloaded_maps_decode_the_same_sdf(saved):
    """The port on the JAX file, JAX on the port's file, and JAX on its own
    file decode the same SDF at 4096 random points (the cell probe)."""
    root, path, qpts = saved
    ts, tm, _ = tio.load_implicit_map(path, device="cpu")
    out = str(root / "port_map_sdf.npz")
    tio.save_implicit_map(out, ts, dict(tm), _cfg(TConfig))
    js, jm, _ = jio.load_implicit_map(path, with_btable=False)
    js2, jm2, _ = jio.load_implicit_map(out, with_btable=False)
    t_sdf, t_nn = _port_sdf(ts, tm, qpts)
    j_sdf, j_nn = _jax_sdf(js, jm, qpts)
    j2_sdf, _ = _jax_sdf(js2, jm2, qpts)
    np.testing.assert_array_equal(t_nn, j_nn)
    assert (t_nn > 0).mean() > 0.9
    np.testing.assert_allclose(t_sdf, j_sdf, atol=SDF_ATOL, rtol=0)
    np.testing.assert_array_equal(j2_sdf, j_sdf)
