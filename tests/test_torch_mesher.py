"""The port's mesher (pin_slam_tpu_torch.slam.mesher, ops.marching,
utils.eval_mesh) against the JAX package's.

* the marching-tetrahedra copy, the cluster filter, split_chunks, write_ply
  and the mesh metrics are numpy code copied unchanged: bit-equal outputs
  on the same numpy inputs;
* query_sdf_grid on one converted map: nn counts equal, SDF <= 1e-5 (the
  decode's float32 sums run in another order; in `weighted_first=False`
  mode the port's grid query goes through the fused decode wrapper, on the
  CPU its plain version);
* recon_map_mesh: a 1e-6 SDF difference may flip a grid cell's sign or its
  nn mask, so the meshes are compared statistically: vertex counts within
  1 %, symmetric vertex-to-vertex Chamfer distance < 1 mm.
"""

import numpy as np
import pytest
import torch
from scipy.spatial import cKDTree

import jax
import jax.numpy as jnp

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.models import neural_points as jnpm
from pin_slam_tpu.ops import marching as jmarch
from pin_slam_tpu.slam import map_query as jmq
from pin_slam_tpu.slam import mesher as jmesh
from pin_slam_tpu.utils import eval_mesh as jeval
from pin_slam_tpu_torch import convert
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.ops import fused_decode as tfd
from pin_slam_tpu_torch.ops import marching as tmarch
from pin_slam_tpu_torch.slam import map_query as tmq
from pin_slam_tpu_torch.slam import mesher as tmesh
from pin_slam_tpu_torch.utils import eval_mesh as teval

jax.config.update("jax_default_matmul_precision", "highest")
RES, F = 0.4, 8


def _grid(kind):
    g = np.arange(-1.5, 1.5, 0.1)
    X, Y, Z = np.meshgrid(g, g, g, indexing="ij")
    sdf = np.sqrt(X ** 2 + Y ** 2 + Z ** 2) - 1.0
    mask = None
    if kind == "masked":
        mask = X <= 0
    elif kind == "two_spheres":
        sdf = np.minimum(sdf, np.sqrt((X - 1.2) ** 2 + Y ** 2 + Z ** 2)
                         - 0.15)
    elif kind == "noisy":
        sdf = sdf + np.random.RandomState(0).randn(*sdf.shape) * 0.02
    elif kind == "empty":
        sdf = np.ones((8, 8, 8))
    return sdf, mask


@pytest.mark.parametrize("kind", ["sphere", "masked", "two_spheres", "noisy",
                                  "empty"])
def test_marching_copy_is_bit_equal(kind):
    sdf, mask = _grid(kind)
    org = np.array([-1.5] * 3)
    jv, jf = jmarch.marching_tetrahedra(sdf, mask, origin=org, voxel_size=0.1)
    tv, tf = tmarch.marching_tetrahedra(sdf, mask, origin=org, voxel_size=0.1)
    assert kind == "empty" or tv.shape[0] > 500
    np.testing.assert_array_equal(tv, jv)
    np.testing.assert_array_equal(tf, jf)
    if kind == "empty":     # the mesher never filters an empty mesh
        return
    for min_v in (30, 300):
        np.testing.assert_array_equal(
            tmarch.filter_small_clusters(tv, tf, min_v),
            jmarch.filter_small_clusters(jv, jf, min_v))


def test_eval_mesh_copy_is_equal():
    sdf, _ = _grid("sphere")
    v, f = tmarch.marching_tetrahedra(sdf, origin=np.array([-1.5] * 3),
                                      voxel_size=0.1)
    tp = teval.sample_mesh_points(v, f, 5000, seed=2)
    np.testing.assert_array_equal(tp, jeval.sample_mesh_points(v, f, 5000,
                                                               seed=2))
    d = np.random.RandomState(0).randn(5000, 3)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    assert teval.eval_mesh(tp, d, threshold=0.05) == jeval.eval_mesh(
        tp, d, threshold=0.05)
    q = np.random.RandomState(1).randn(50, 3)
    np.testing.assert_array_equal(teval.point_to_mesh_distance(q, v, f),
                                  jeval.point_to_mesh_distance(q, v, f))


@pytest.mark.parametrize("lo,hi,chunk", [
    ((0.0, 0.0, -2.0), (250.0, 90.0, 10.0), 100.0),
    ((-30.0, -80.0, 0.0), (31.0, 75.0, 4.0), 36.0),
    ((0.0, 0.0, 0.0), (10.0, 10.0, 3.0), 100.0)])
def test_split_chunks_equal(lo, hi, chunk):
    lo, hi = np.array(lo, np.float32), np.array(hi, np.float32)
    tc = tmesh.Mesher.split_chunks(lo, hi, chunk)
    jc = jmesh.Mesher.split_chunks(lo, hi, chunk)
    assert len(tc) == len(jc) > 0
    for (a, b), (c, d) in zip(tc, jc):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)


@pytest.mark.parametrize("with_colors", [False, True])
def test_write_ply_equal(tmp_path, with_colors):
    sdf, _ = _grid("sphere")
    v, f = tmarch.marching_tetrahedra(sdf[::3, ::3, ::3],
                                      origin=np.array([-1.5] * 3),
                                      voxel_size=0.3)
    col = np.random.RandomState(0).rand(v.shape[0], 3) if with_colors \
        else None
    tmesh.write_ply(str(tmp_path / "t.ply"), v, f, col)
    jmesh.write_ply(str(tmp_path / "j.ply"), v, f, col)
    text = (tmp_path / "t.ply").read_text()
    assert text.startswith("ply\n") and f"element vertex {len(v)}" in text
    assert text == (tmp_path / "j.ply").read_text()


# ------------------------------------------------------------ on one map


def _cfg(cls, weighted_first):
    c = cls()
    c.voxel_size_m = RES
    c.probe_mode = "join"
    c.weighted_first = weighted_first
    return c.finalize()


@pytest.fixture(scope="module")
def world():
    """A map over the surface z = 0.4 sin x + 0.2 cos y with a decoder
    whose first two hidden units read the offset's z (so the SDF is close
    to the height above the surface) and whose other units add a smaller
    feature-driven term."""
    rng = np.random.RandomState(0)
    n = 6000
    p = np.zeros((n, 3), np.float32)
    p[:, :2] = rng.rand(n, 2) * 12 - 6
    p[:, 2] = 0.4 * np.sin(p[:, 0]) + 0.2 * np.cos(p[:, 1])
    js = jnpm.init_map_state(1 << 13, 1 << 15, F, color_on=False,
                             with_btable=False)
    js, _ = jnpm.insert_points(js, jnp.asarray(p), jnp.ones(n, bool), 0,
                               jnp.zeros(4), resolution=RES,
                               local_window_dist=50.0, maintain_btable=False)
    cnt = int(js.count)
    feats = np.zeros((js.capacity + 1, F), np.float32)
    feats[:cnt] = rng.randn(cnt, F).astype(np.float32) * 0.3
    js = js.replace(geo_features=jnp.asarray(feats))
    scale = JConfig().sdf_scale
    w0 = (rng.randn(F + 3, 64) * 0.05).astype(np.float32)
    w0[:, :2] = 0.0
    w0[F + 2, 0], w0[F + 2, 1] = 1.0, -1.0
    w1 = (rng.randn(64, 1) * 0.05).astype(np.float32)
    w1[0, 0], w1[1, 0] = 1.0 / scale, -1.0 / scale
    mlp_np = {"w": [w0, w1], "b": [np.zeros(64, np.float32),
                                   np.zeros(1, np.float32)]}
    jmlp = {"w": [jnp.asarray(w) for w in mlp_np["w"]],
            "b": [jnp.asarray(b) for b in mlp_np["b"]]}
    params, ts = convert.from_jax(
        {"geo_mlp": mlp_np},
        {f: np.array(getattr(js, f)) for f in convert.STATE_FIELDS})
    return js, jmlp, ts, params


def _meshers(weighted_first, **kw):
    mc = dict(mc_res_m=0.3, mesh_min_nn=8, min_cluster_vertices=50,
              infer_bs=4096, chunk_m=7.0)
    mc.update(kw)
    jm = jmesh.Mesher(jmq.make_query_params(_cfg(JConfig, weighted_first)),
                      jmesh.MeshConfig(**mc))
    tm = tmesh.Mesher(tmq.make_query_params(_cfg(TConfig, weighted_first)),
                      tmesh.MeshConfig(**mc))
    return jm, tm


@pytest.mark.parametrize("weighted_first", [True, False])
def test_query_sdf_grid(world, weighted_first):
    js, jmlp, ts, params = world
    jm, tm = _meshers(weighted_first)
    origin = np.array([-3.0, -2.0, -1.2])
    dims = (21, 17, 9)         # 3213 points: one ragged batch of 4096
    jm.mc.infer_bs = tm.mc.infer_bs = 1000   # and 4 batches, the last ragged
    jsdf, jnn = jm.query_sdf_grid(js, js.geo_features, jmlp, origin, dims)
    n0 = tfd.LAUNCHES
    tsdf, tnn = tm.query_sdf_grid(ts, params["geo_features"],
                                  params["geo_mlp"], origin, dims)
    assert tm.n_batches == 4 and tfd.LAUNCHES == n0    # CPU: no launch
    assert tm.decode_route == ("plain" if weighted_first else "fused_decode")
    assert tsdf.shape == dims and tnn.dtype == np.int32
    assert (jnn >= 8).mean() > 0.3 and np.abs(jsdf).max() > 0.3
    np.testing.assert_array_equal(tnn, jnn)
    np.testing.assert_allclose(tsdf, jsdf, atol=1e-5)


def _chamfer(a, b):
    return 0.5 * (cKDTree(b).query(a)[0].mean() + cKDTree(a).query(b)[0].mean())


@pytest.mark.parametrize("weighted_first", [True, False])
def test_recon_map_mesh(world, weighted_first):
    js, jmlp, ts, params = world
    jm, tm = _meshers(weighted_first)
    jv, jf = jm.recon_map_mesh(js, js.geo_features, jmlp)
    tv, tf = tm.recon_map_mesh(ts, params["geo_features"], params["geo_mlp"])
    assert jv.shape[0] > 2000 and tf.shape[0] > 2000
    assert tm.n_batches >= 4          # 4 chunks of the 12 m map at 7 m
    assert abs(tv.shape[0] - jv.shape[0]) <= 0.01 * jv.shape[0]
    assert abs(tf.shape[0] - jf.shape[0]) <= 0.01 * jf.shape[0]
    assert _chamfer(tv, jv) < 1e-3
    # and the mesh is the surface the map was built on
    kept = tv[np.unique(tf)]
    z = 0.4 * np.sin(kept[:, 0]) + 0.2 * np.cos(kept[:, 1])
    assert np.median(np.abs(kept[:, 2] - z)) < 0.05


def test_recon_empty_map():
    from pin_slam_tpu_torch.models import neural_points as tnpm
    _, tm = _meshers(False)
    ts = tnpm.init_map_state(256, 1 << 10, F)
    v, f = tm.recon_map_mesh(ts, ts.geo_features, None)
    assert v.shape == (0, 3) and f.shape == (0, 3) and tm.n_batches == 0


@pytest.mark.parametrize("axis", ["z", "x"])
def test_sdf_slice(world, axis):
    js, jmlp, ts, params = world
    jm, tm = _meshers(False)
    center = np.array([0.5, -0.5, 0.0])
    jx, jy, js_ = jm.sdf_slice(js, js.geo_features, jmlp, center, 3.0, 0.2,
                               axis=axis)
    tx, ty, ts_ = tm.sdf_slice(ts, params["geo_features"], params["geo_mlp"],
                               center, 3.0, 0.2, axis=axis)
    np.testing.assert_array_equal(tx, jx)
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(ts_, js_, atol=1e-5)
