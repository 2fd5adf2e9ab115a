"""Tests of the port that need the card (marked `cuda`; they skip without
one). This file imports torch and numpy only, so it runs where JAX is not
installed:  python -m pytest tests/test_torch_cuda.py -m cuda"""

import numpy as np
import pytest
import torch

from pin_slam_tpu_torch.ops import fused_decode as tfd
from pin_slam_tpu_torch.ops import knn_join as tkj


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU mode)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 6, 8, 12, 16])
def test_knn_kernel_matches_plain(cuda, k):
    """Kernel vs plain version on the same prepared inputs: idx, d2, cnt
    and the per-tile visit counts are equal."""
    qp, lp = _dense_case(cuda)
    qs, tab, bbd, perm, md2 = tkj.prepare(qp, lp, 1.44, 0.4)
    n0 = tkj.LAUNCHES
    got = tkj._knn_walk_cuda(qs, lp, tab, bbd, perm, k, md2)
    ref = tkj._knn_walk_plain(qs, lp, tab, bbd, perm, k, md2)
    torch.cuda.synchronize()
    assert tkj.LAUNCHES == n0 + 1
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


def _sorted_local(p, dev):
    """Morton-sorted, padded local set and the matching torch tensor."""
    pt = torch.as_tensor(p, device=dev)
    L = pt.shape[0]
    si = tkj._sort_by_morton(pt, torch.ones(L, dtype=torch.bool, device=dev),
                             1.6)
    return torch.cat([pt[si], torch.full(((-L) % tkj.TL, 3), tkj.PAD,
                                         device=dev)])


def _pad_queries(q, dev):
    return torch.cat([torch.as_tensor(q, device=dev),
                      torch.full(((-len(q)) % tkj.TQ, 3), tkj.PAD,
                                 device=dev)])


def _dense_case(dev, n_q=1024, L=16384, seed=1):
    """A wavy 60 x 60 m sheet of L points, queries ~5 cm off it."""
    rng = np.random.RandomState(seed)
    p = np.zeros((L, 3), np.float32)
    p[:, :2] = rng.rand(L, 2) * 60 - 30
    p[:, 2] = 0.2 * np.sin(p[:, 0])
    q = p[rng.randint(0, L, n_q)] + rng.randn(n_q, 3).astype(np.float32) * 0.05
    return _pad_queries(q, dev), _sorted_local(p, dev)


def _walk_both(qp, lp, k, max_d2, qperm=None):
    qs, tab, bbd, perm, md2 = tkj.prepare(qp, lp, max_d2, 0.4, qperm)
    got = tkj._knn_walk_cuda(qs, lp, tab, bbd, perm, k, md2)
    ref = tkj._knn_walk_plain(qs, lp, tab, bbd, perm, k, md2)
    torch.cuda.synchronize()
    return got, ref


@pytest.mark.cuda
def test_knn_kernel_matches_plain_at_the_tracker_shape(cuda):
    """The tracker's probe: 16384 queries, k = 12, a 65536-row local set."""
    qp, lp = _dense_case(cuda, n_q=16384, L=65536, seed=4)
    got, ref = _walk_both(qp, lp, 12, 1.44)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_knn_kernel_matches_plain_at_the_color_tracker_shape(cuda):
    """The colour tracker's probe at every GN iteration: 8192 queries
    (run_kitti_color.yaml's source cap), k = 6, a 65536-row local set."""
    qp, lp = _dense_case(cuda, n_q=8192, L=65536, seed=6)
    got, ref = _walk_both(qp, lp, 6, 1.44)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_knn_kernel_matches_plain_at_the_localization_shape(cuda):
    """Localization's probe: a source cloud spread over the whole scan
    (8192 queries, run_kitti.yaml's source cap, the tracker's 12
    candidates) against the join set built once over a whole map (131072
    rows, every one live)."""
    qp, lp = _dense_case(cuda, n_q=8192, L=131072, seed=8)
    got, ref = _walk_both(qp, lp, 12, 1.44)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_knn_kernel_refuses_a_misaligned_local_set(cuda):
    """A local set one row (12 bytes) into its storage is not 16-byte
    aligned, which the kernel's 16-byte copies need: the wrapper raises
    and launches nothing."""
    qp, lp = _dense_case(cuda, seed=6)
    shifted = torch.empty((lp.shape[0] + 1, 3), device=cuda)
    shifted[1:] = lp
    lp = shifted[1:]
    assert lp.is_contiguous() and lp.data_ptr() % 16 != 0
    n0 = tkj.LAUNCHES
    with pytest.raises(ValueError, match="16-byte"):
        _walk_both(qp, lp, 8, 1.44)
    assert tkj.LAUNCHES == n0


@pytest.mark.cuda
@pytest.mark.parametrize("k", [4, 12, 16])
def test_knn_kernel_walks_the_whole_row(cuda, k):
    """Queries in random order, so every query tile spans the whole cloud
    and each local tile's bounding-box distance is 0: no query tile can
    stop early and each walks all 32 tiles of its row. The radius is wider
    than the cloud, so the first tiles merge hundreds of insertions across
    the column groups."""
    rng = np.random.RandomState(5)
    p = rng.rand(32 * tkj.TL, 3).astype(np.float32) * 10
    q = _pad_queries(rng.rand(1000, 3).astype(np.float32) * 10, cuda)
    perm = torch.as_tensor(rng.permutation(q.shape[0]), device=cuda)
    got, ref = _walk_both(q, _sorted_local(p, cuda), k, 1000.0, perm)
    assert int(got[3].max()) == tkj.ROW_CAP
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("k", [6, 12, 16])
def test_knn_kernel_ties_are_bit_equal(cuda, k):
    """Every point of a 0.25 m lattice three times over, shuffled, queries
    on and between lattice points: equal distances fall across columns,
    tiles and the kernel's column groups (the case of
    tests/test_torch_knn_join.py::_case_ties, which holds the plain version
    to the JAX kernel)."""
    rng = np.random.RandomState(2)
    g = np.stack(np.meshgrid(np.arange(24), np.arange(24), np.arange(4),
                             indexing="ij"), -1).reshape(-1, 3)
    p = np.repeat(g.astype(np.float32) * 0.25, 3, axis=0)
    p = p[rng.permutation(len(p))]
    q = p[rng.randint(0, len(p), 512)] + \
        rng.randint(0, 2, (512, 3)).astype(np.float32) * 0.125
    got, ref = _walk_both(_pad_queries(q, cuda), _sorted_local(p, cuda), k,
                          1.44)
    d2 = ref[1]
    assert int((d2[:, 1:] == d2[:, :-1]).sum()) > d2.shape[0]  # many ties
    for a, b in zip(got, ref):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_knn_join_on_cuda_tensor_launches_kernel(cuda):
    qp, lp = _dense_case(cuda, n_q=300)
    n0 = tkj.LAUNCHES
    idx, d2, cnt = tkj.knn_join(qp, lp, k=6, max_dist2=1.44, resolution=0.4)
    torch.cuda.synchronize()
    assert tkj.LAUNCHES == n0 + 1
    assert idx.is_cuda and (idx[:300, 0] >= 0).all()


def _decode_case(dev, n, k, f, h, seed=0, hidden_layers=1):
    rng = np.random.RandomState(seed)
    d = f + 3
    gv = rng.randn(n, k, d).astype(np.float32) * 0.4
    w = rng.rand(n, k).astype(np.float32)
    w /= w.sum(-1, keepdims=True)
    dims = [d] + [h] * hidden_layers + [1]
    mlp = {"w": [torch.as_tensor(rng.randn(a, b).astype(np.float32) * 0.3,
                                 device=dev)
                 for a, b in zip(dims[:-1], dims[1:])],
           "b": [torch.as_tensor(rng.randn(b).astype(np.float32) * 0.1,
                                 device=dev) for b in dims[1:]]}
    return torch.as_tensor(gv, device=dev), torch.as_tensor(w, device=dev), mlp


@pytest.mark.cuda
@pytest.mark.parametrize("n,k,f,h", [(524288, 6, 8, 64), (777, 8, 8, 64),
                                     (1, 1, 8, 64), (5000, 5, 13, 37)])
def test_fused_decode_kernel_matches_plain(cuda, n, k, f, h):
    """Kernel vs plain version, 1e-5: float32 sums in another order at
    outputs of O(0.1). One launch, counted."""
    gv, w, mlp = _decode_case(cuda, n, k, f, h)
    args = (gv, w, mlp["w"][0], mlp["b"][0], mlp["w"][1], mlp["b"][1], 0.05)
    n0 = tfd.LAUNCHES
    got = tfd.decode_weighted_sdf(*args)
    torch.cuda.synchronize()
    assert tfd.LAUNCHES == n0 + 1
    ref = tfd.decode_weighted_sdf_reference(*args)
    assert got.shape == (n,) and got.is_cuda
    assert float(ref.abs().max()) > 1e-3
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("n,k", [(1000, 5), (100003, 5), (1000, 7),
                                 (100003, 7)])
def test_fused_decode_ragged_tiles(cuda, n, k):
    """A tile holds floor(512 / k) whole queries (102 at k = 5, 73 at
    k = 7); N is no multiple of it, so the last tile is partly masked."""
    gv, w, mlp = _decode_case(cuda, n, k, 8, 64, seed=1)
    args = (gv, w, mlp["w"][0], mlp["b"][0], mlp["w"][1], mlp["b"][1], 0.05)
    got = tfd.decode_weighted_sdf(*args)
    torch.cuda.synchronize()
    ref = tfd.decode_weighted_sdf_reference(*args)
    assert got.shape == (n,) and bool(torch.isfinite(got).all())
    assert float((got - ref).abs().max()) <= 1e-5


@pytest.mark.cuda
def test_fused_decode_refuses_other_decoders_on_the_card(cuda):
    gv, w, two = _decode_case(cuda, 64, 6, 8, 64, hidden_layers=2)
    n0 = tfd.LAUNCHES
    with pytest.raises(ValueError, match="one-hidden-layer"):
        tfd.decode_weighted_sdf_mlp(gv, w, two, 0.05)
    _, _, one = _decode_case(cuda, 64, 6, 8, 64)
    with pytest.raises(ValueError, match="leaky"):
        tfd.decode_weighted_sdf_mlp(gv, w, one, 0.05, leaky=True)
    with pytest.raises(ValueError, match="float32"):
        tfd.decode_weighted_sdf_mlp(gv.double(), w, one, 0.05)
    assert tfd.LAUNCHES == n0


@pytest.mark.cuda
def test_index_add_exact_is_repeatable_on_the_card(cuda):
    """The fixed-point scatter-add gives the same bits on every call on the
    card, where the additions run as atomics in any order, and the bits of
    the CPU result."""
    from pin_slam_tpu_torch.ops.scatter import index_add_exact

    rng = np.random.RandomState(3)
    m, rows = 400000, 3000
    idx = torch.as_tensor(rng.randint(0, rows, m))
    src = torch.as_tensor((rng.randn(m, 8) * 1e-5).astype(np.float32))
    dst = torch.zeros(rows, 8)
    want = index_add_exact(dst, idx, src)
    for _ in range(3):
        got = index_add_exact(dst.to(cuda), idx.to(cuda), src.to(cuda))
        assert torch.equal(got.cpu(), want)


def _closure_case(dev, seed=0, C=1 << 17, P=1 << 20, T=40):
    """A seeded map (C rows, 90 % alive, over 40 frames), a replay pool of
    P rows and per-frame corrections [T, 4, 4] of up to ~3 deg / 0.3 m."""
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.ops.transforms import so3_exp

    rng = np.random.RandomState(seed)
    s = npm.init_map_state(C, 1 << 20, 8, device=dev)
    n = int(C * 0.9)
    s.positions[:n] = torch.as_tensor(
        rng.uniform(-30, 30, (n, 3)).astype(np.float32), device=dev)
    s.ts_create[:n] = torch.as_tensor(rng.randint(0, T + 3, n), device=dev)
    s.ts_update[:n] = s.ts_create[:n] + torch.as_tensor(
        rng.randint(0, 5, n), device=dev)
    s.count = torch.tensor(n, device=dev)
    diffs = torch.eye(4, device=dev).repeat(T, 1, 1)
    diffs[:, :3, :3] = so3_exp(torch.as_tensor(
        rng.randn(T, 3).astype(np.float32) * 0.03, device=dev))
    diffs[:, :3, 3] = torch.as_tensor(
        rng.randn(T, 3).astype(np.float32) * 0.2, device=dev)
    coord = torch.as_tensor(rng.uniform(-30, 30, (P, 3)).astype(np.float32),
                            device=dev)
    pts = torch.as_tensor(rng.randint(0, T + 3, P), device=dev)
    return s, coord, pts, diffs


def _consequences(s, coord, pts, diffs):
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.ops.transforms import transform_points_by_ts

    d = npm.deform_map(s, diffs, use_mid_ts=True)
    r = npm.rehash(d, diffs.shape[0] - 1, resolution=0.4, use_mid_ts=True)
    return r, transform_points_by_ts(coord, pts, diffs)


@pytest.mark.cuda
def test_closure_consequences_on_the_card(cuda):
    """One closure's device work (deform_map, rehash, replay-pool
    transform) on the card: within 1e-5 of the CPU result (float32
    rounding of the affine sums may differ), the rehash of the card's
    deformed map equal to the CPU's rehash of the same positions, and a
    second run on the card the same bit for bit."""
    from pin_slam_tpu_torch.models import neural_points as npm

    g1, gc1 = _consequences(*_closure_case(cuda))
    g2, gc2 = _consequences(*_closure_case(cuda))
    c1, cc1 = _consequences(*_closure_case("cpu"))
    torch.cuda.synchronize()
    for a, b in ((g1.positions, g2.positions),
                 (g1.orientations, g2.orientations), (g1.table, g2.table),
                 (gc1, gc2)):
        assert torch.equal(a, b)
    for a, b in ((g1.positions, c1.positions),
                 (g1.orientations, c1.orientations), (gc1, cc1)):
        assert float((a.cpu() - b).abs().max()) <= 1e-5
    moved = (g1.positions.cpu() - _closure_case("cpu")[0].positions).abs()
    assert float(moved.max()) > 0.1
    on_cpu = npm.rehash(
        c1.replace(positions=g1.positions.cpu()), 39, resolution=0.4,
        use_mid_ts=True)
    assert torch.equal(g1.table.cpu(), on_cpu.table)


def _ba_filter_case(dev, seed=0, weighted_first=False, color=False):
    """A system on `dev` (weighted_first=False: the filter decodes through
    the fused kernel) holding a seeded map of a 12 m box room's walls with
    random features, and a replay pool of the walls' surface samples over
    four frames (with `color`: a colour system, the samples coloured by
    `procedural_color`)."""
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.slam import mapper as mp
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    rng = np.random.RandomState(seed)
    c = Config()
    c.track_on = True
    c.weighted_first = weighted_first
    c.voxel_size_m = 0.4
    c.map_capacity, c.buffer_size = 1 << 16, 1 << 18
    c.frame_point_cap, c.source_point_cap, c.max_frames = 1 << 14, 1 << 10, 8
    c.color_on, c.color_channel = color, 3 if color else 0
    c.finalize()
    c.pool_capacity = 1 << 17
    system = PinSLAMSystem(c, device=dev)
    n = 40000
    walls = rng.uniform(-6, 6, (n, 3)).astype(np.float32)
    axis = rng.randint(0, 3, n)
    walls[np.arange(n), axis] = np.sign(walls[np.arange(n), axis]) * 6.0
    pts = torch.as_tensor(walls, device=dev)
    system.state, _ = npm.insert_points(
        system.state, pts, torch.ones(n, dtype=torch.bool, device=dev), 0,
        torch.zeros(c.max_frames, device=dev), resolution=c.voxel_size_m,
        local_window_dist=1e9, force_all_new=True, insert_cap=1 << 16)
    cnt = int(system.state.count)
    system.state.geo_features[:cnt] = torch.as_tensor(
        rng.randn(cnt, c.feature_dim).astype(np.float32), device=dev)
    system.state.certainty[:cnt] = 5.0
    system.params["geo_features"] = system.state.geo_features
    # decoded SDFs spread around the filter's 0.2 m threshold
    system.params["geo_mlp"]["b"][-1] += 3.6
    colors = None
    if color:
        from pin_slam_tpu_torch.dataset.synthetic import procedural_color
        system.state.color_features[:cnt] = torch.as_tensor(
            rng.randn(cnt, c.feature_dim).astype(np.float32), device=dev)
        colors = torch.as_tensor(procedural_color(
            walls.astype(np.float64)).astype(np.float32), device=dev)
    for f in range(4):
        system.pool = mp.append_samples(
            system.pool, pts[f::4], torch.zeros(len(pts[f::4]), device=dev),
            torch.ones(len(pts[f::4]), device=dev),
            torch.ones(len(pts[f::4]), dtype=torch.bool, device=dev), f,
            color_label=None if colors is None else colors[f::4])
        system.odom_poses[f] = np.eye(4)
    return system, pts


@pytest.mark.cuda
def test_bundle_adjustment_repeats_bit_for_bit_on_the_card(cuda):
    """Two BA runs from the same state with the same draws give the same
    bits on the card (the backward pass's repeated-index sums are
    order-free), and BA lowers its loss."""
    from pin_slam_tpu_torch.slam import ba

    outs = []
    for _ in range(2):
        system, _ = _ba_filter_case(cuda)
        gen = torch.Generator(device=cuda).manual_seed(3)
        loop = ba.make_ba_loop(system.qp, n_iters=8, bs=8192, window=4,
                               lr_pose=1e-4, lr_map=0.01)
        outs.append(loop(system.state, system.pool,
                         system.params["geo_features"],
                         system.params["geo_mlp"],
                         system._tensor(system.odom_poses[:4]), 0, gen,
                         system._lf(3)))
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    losses = outs[0][2]
    assert bool(torch.isfinite(losses).all()) and losses[-1] < losses[0]


@pytest.mark.cuda
def test_replayed_bundle_adjustment_is_bit_equal_to_the_eager_loop(cuda):
    """A BA run whose iterations 2..n replay the graph it captured (the
    default on the card) gives the eager loop's bits (`_eager=True`):
    poses, features and every loss; one capture, n - 1 replays."""
    from pin_slam_tpu_torch.slam import ba
    from pin_slam_tpu_torch.utils import tracing

    outs, names = [], None
    for eager in (True, False):
        system, _ = _ba_filter_case(cuda)
        gen = torch.Generator(device=cuda).manual_seed(3)
        loop = ba.make_ba_loop(system.qp, n_iters=8, bs=8192, window=4,
                               lr_pose=1e-4, lr_map=0.01, _eager=eager)
        tracing.drain()
        tracing.enable()
        try:
            outs.append(loop(system.state, system.pool,
                             system.params["geo_features"],
                             system.params["geo_mlp"],
                             system._tensor(system.odom_poses[:4]), 0, gen,
                             system._lf(3)))
        finally:
            tracing.disable()
        names = [r.name for r in tracing.drain()]
        assert names.count("ba.capture") == (0 if eager else 1)
        assert names.count("ba.replay") == (0 if eager else 7)
        assert names.count("ba.iter") == names.count("ba.step") == 8
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_dynamic_filter_fused_route_matches_plain_on_the_card(cuda):
    """The filter under weighted_first=False launches the fused decode
    kernel once; its SDF agrees with the plain decode to 1e-5 and the two
    routes' static masks differ only where the SDF lies within 1e-5 of a
    threshold."""
    from pin_slam_tpu_torch.slam import map_query as mq

    system, pts = _ba_filter_case(cuda)
    c = system.config
    rng = np.random.RandomState(1)
    q = pts[:16384] + torch.as_tensor(
        rng.randn(16384, 3).astype(np.float32) * 0.3, device=cuda)
    mask = torch.ones(len(q), dtype=torch.bool, device=cuda)
    lf = system._lf(0)
    n0 = tfd.LAUNCHES
    fused = system.dynamic_filter(q, mask, lf)
    assert tfd.LAUNCHES == n0 + 1
    plain = system.dynamic_filter(q, mask, lf, fused=False)
    assert tfd.LAUNCHES == n0 + 1
    with torch.no_grad():
        a = mq.query_decode(system.params["geo_features"],
                            system.params["geo_mlp"], q, system.qp,
                            state=system.state, lf=lf, fused=True)
        b = mq.query_decode(system.params["geo_features"],
                            system.params["geo_mlp"], q, system.qp,
                            state=system.state, lf=lf)
    torch.cuda.synchronize()
    assert float((a.sdf - b.sdf).abs().max()) <= 1e-5
    near = (b.sdf - c.dynamic_sdf_ratio_thre * c.voxel_size_m).abs() <= 1e-5
    assert not bool(((fused != plain) & ~near).any())
    assert 0 < int((~plain).sum()) < len(q)


@pytest.mark.cuda
def test_color_training_step_repeats_bit_for_bit_on_the_card(cuda):
    """Two colour training runs from the same state with the same draws
    give the same bits on the card: the geometry and colour features'
    backward sums are order-free, and so are the certainty sums."""
    outs = []
    for _ in range(2):
        system, _ = _ba_filter_case(cuda, color=True)
        lset = system.build_lset_train(
            system._tensor(system.travel_dist[: system.max_frames]), 3, 0)
        gen = torch.Generator(device=cuda).manual_seed(5)
        loop = system._get_train_loop(3, True)
        params, state, losses = loop(system.params, system.state,
                                     system.pool, gen,
                                     torch.tensor(True, device=cuda), lset)
        outs.append([state.geo_features, state.color_features,
                     state.certainty, losses]
                    + params["color_mlp"]["w"] + params["geo_mlp"]["w"])
    torch.cuda.synchronize()
    for a, b in zip(*outs):
        assert torch.equal(a, b)
    assert bool(torch.isfinite(outs[0][3]).all())


@pytest.mark.cuda
def test_brick_cache_and_probe_match_the_cpu_on_the_card(cuda):
    """The brick cache after inserts that alias bricks (a 2^14 table keeps
    1024 bricks) and a rehash, and the brick probe with the time and radius
    filters: bit-equal on the card and on the CPU (the repeated-slot
    writes of `ops/scatter.set_last_` agree however `index_put_` orders
    them)."""
    from pin_slam_tpu_torch.models import neural_points as tnpm
    from pin_slam_tpu_torch.ops import hash3d as th

    rng = np.random.RandomState(0)
    travel = torch.as_tensor(np.arange(16, dtype=np.float32) * 3.0)
    scans = []
    for shift in (0.0, 1.3):
        p = np.zeros((6000, 3), np.float32)
        p[:, :2] = rng.rand(6000, 2) * 24 - 12 + shift
        p[:, 2] = 0.3 * np.sin(p[:, 0]) + rng.randn(6000) * 0.02
        scans.append(p)
    q = torch.as_tensor(scans[1][:2000] + rng.randn(2000, 3).astype(
        np.float32) * 0.3)
    out = {}
    for dev in ("cpu", cuda):
        s = tnpm.init_map_state(8192, 1 << 14, 8, device=dev)
        for ts, p in enumerate(scans):
            s, _ = tnpm.insert_points(
                s, torch.as_tensor(p, device=dev),
                torch.ones(len(p), dtype=torch.bool, device=dev), ts * 9,
                travel.to(dev), resolution=0.4, local_window_dist=20.0)
        inserted = s.btable.clone()
        s = tnpm.rehash(s, 9, resolution=0.4, use_mid_ts=True)
        qn = tnpm.query_neighbors(
            s, q.to(dev), offsets=th.neighbor_offsets(2, 0.2),
            resolution=0.4, nn_k=8, max_dist2=th.max_valid_dist2(2, 0.4),
            probe_mode="brick", time_filter=True, travel_dist=travel.to(dev),
            cur_ts=9, local_window_dist=20.0, radius_filter=True,
            sensor_pos=torch.tensor([1.0, -2.0, 0.0], device=dev),
            local_map_radius=9.0, use_mid_ts=True)
        out[str(dev)] = [t.cpu() for t in (inserted, s.btable, qn.idx,
                                           qn.dist2, qn.valid, qn.nn_count)]
    assert int(out["cpu"][5].sum()) > 1000
    for a, b in zip(out["cpu"], out[str(cuda)]):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_sharded_mesher_is_bit_equal_on_the_card(cuda):
    """The mesher sharded over two replicas on the one card (`["cuda:0"] *
    2`, parallel/dp.make_mesh) against the unsharded one on a seeded map
    under weighted_first=False: the same grid and the same mesh bit for
    bit, and the fused decode launched twice a grid batch."""
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.models import neural_points as npm
    from pin_slam_tpu_torch.models.decoder import init_mlp_params
    from pin_slam_tpu_torch.parallel import dp
    from pin_slam_tpu_torch.slam import map_query as mq
    from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher

    rng = np.random.RandomState(0)
    p = np.zeros((20000, 3), np.float32)
    p[:, :2] = rng.rand(20000, 2) * 20 - 10
    p[:, 2] = 0.5 * np.sin(p[:, 0])
    c = Config()
    c.voxel_size_m, c.weighted_first = 0.3, False
    c.finalize()
    s = npm.init_map_state(1 << 15, 1 << 17, 8, device=cuda,
                           with_btable=False)
    s, _ = npm.insert_points(s, torch.as_tensor(p, device=cuda),
                             torch.ones(len(p), dtype=torch.bool,
                                        device=cuda), 0,
                             torch.zeros(8, device=cuda), resolution=0.3,
                             local_window_dist=100.0)
    s.geo_features.normal_(0.0, 0.1, generator=torch.Generator(
        device=cuda).manual_seed(1))
    mlp = init_mlp_params(torch.Generator().manual_seed(2), 11, 64, 1, 1,
                          True, device=cuda)
    qp = mq.make_query_params(c)
    mc = MeshConfig(mc_res_m=0.2, infer_bs=1 << 16, mesh_min_nn=4,
                    min_cluster_vertices=0)
    args = (s, s.geo_features, mlp)
    plain = Mesher(qp, mc)
    sharded = Mesher(qp, mc, mesh=dp.make_mesh(devices=[cuda] * 2))
    origin, dims = np.array([-10.0, -10.0, -1.0]), (101, 101, 11)
    n0 = tfd.LAUNCHES
    sdf_a, nn_a = plain.query_sdf_grid(*args, origin, dims)
    n1 = tfd.LAUNCHES
    sdf_b, nn_b = sharded.query_sdf_grid(*args, origin, dims)
    n2 = tfd.LAUNCHES
    assert plain.decode_route == sharded.decode_route == "fused_decode"
    assert n2 - n1 == 2 * (n1 - n0) == 2 * plain.n_batches
    assert np.array_equal(sdf_a, sdf_b) and np.array_equal(nn_a, nn_b)
    assert int((nn_a > 0).sum()) > 1000
    va, fa = plain.recon_map_mesh(*args)
    vb, fb = sharded.recon_map_mesh(*args)
    assert np.array_equal(va, vb) and np.array_equal(fa, fb)


def _profiled_frame(dev, traced, n_frames=4):
    """A small cell-probe system with the loop manager, `n_frames` frames
    with the tracer on or off; the last frame under torch.profiler.
    Returns the poses and the profile's events."""
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.dataset.synthetic import (
        SyntheticSequence, circle_trajectory, default_scene,
        lidar_directions)
    from pin_slam_tpu_torch.slam.loop import LoopPgoManager
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem
    from pin_slam_tpu_torch.utils import tracing

    c = Config()
    c.track_on, c.pgo_on, c.probe_mode, c.silence = True, True, "cells", True
    c.voxel_size_m, c.sigma_sigmoid_m, c.loss_weight_on = 0.3, 0.1, True
    c.vox_down_m, c.source_vox_down_m = 0.08, 0.4
    c.bs, c.iters, c.init_iter_ratio, c.bs_new_sample = 2048, 6, 20, 512
    c.map_capacity, c.buffer_size, c.max_frames = 1 << 17, 1 << 19, 16
    c.finalize()
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(n_frames, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(1024, 32), max_range=60.0)
    system = PinSLAMSystem(c, device=dev)
    system.set_gt_poses(seq.poses)
    loop_mgr = LoopPgoManager(c, system)
    poses, prof = [], None
    if traced:
        tracing.enable()
    try:
        for fid in range(n_frames):
            pts = seq.frame(fid)
            if fid == n_frames - 1:
                torch.cuda.synchronize()
                prof = torch.profiler.profile(activities=[
                    torch.profiler.ProfilerActivity.CPU,
                    torch.profiler.ProfilerActivity.CUDA])
                prof.start()
            poses.append(system.process_frame(
                fid, pts, loop_hook=lambda f, _p=pts: loop_mgr.after_frame(
                    f, _p)))
        torch.cuda.synchronize()
        prof.stop()
    finally:
        tracing.disable()
        tracing.drain()
    return np.stack(poses), prof.events()


@pytest.mark.cuda
def test_the_tracer_adds_no_device_op_and_no_sync(cuda):
    """The same frames with the tracer off and on: in the profiled frame
    the runtime's kernel launches, copies, sets and syncs are as many, the
    device operations the same by name, and the poses bit-equal; only the
    traced run's trace holds the program's `pin_slam.*` ranges, and none
    of them on the device's timeline. The device events of pageable
    host-to-device copies are left out of the comparison by name: their
    count varies between two runs with the tracer off (101 and 102 for the
    same 635 copy calls), while the copy calls are compared. The profiler
    is started once before either run: the training's captured iteration
    (`slam/mapper.py::_WholeMapGraph`) is instantiated on frame 0, and
    one instantiated before the process's first profile runs some of its
    device copies as kernels (`memcpy32_post`), one after as copies."""
    from collections import Counter

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]):
        torch.ones(1, device=cuda).add_(1)
        torch.cuda.synchronize()
    calls, ops, poses = {}, {}, {}
    for traced in (False, True):
        poses[traced], events = _profiled_frame(cuda, traced)
        c, d = Counter(), Counter()
        for e in events:
            name = e.name
            if e.device_type == torch.autograd.DeviceType.CUDA:
                if name.startswith("pin_slam."):
                    c["device_ranges"] += 1
                elif not (getattr(e, "is_user_annotation", False)
                          or name.startswith("Memcpy HtoD (Pageable")):
                    d[name] += 1
            elif name.startswith("pin_slam."):
                c["ranges"] += 1
            elif name.startswith(("cudaLaunch", "cudaMemcpy", "cudaMemset",
                                  "cudaStreamSynchronize",
                                  "cudaDeviceSynchronize",
                                  "cudaEventSynchronize")):
                c[name] += 1
        calls[traced], ops[traced] = c, d
    off, on = calls[False], calls[True]
    assert sum(v for k, v in off.items() if k.startswith("cudaLaunch")) \
        > 100 and off["ranges"] == 0
    assert on["ranges"] > 10 and on["device_ranges"] == 0
    del on["ranges"], off["ranges"]
    assert off == on
    assert ops[False] == ops[True], (ops[False] - ops[True],
                                     ops[True] - ops[False])
    assert np.array_equal(poses[False], poses[True])


@pytest.mark.cuda
@pytest.mark.parametrize("variant", ["cells", "brick", "full"])
def test_replayed_training_is_bit_equal_to_the_eager_loop(cuda, variant):
    """`tests/train_graph_case.py` on the card twice, under the cell and
    the brick probe and with every branch of the iteration on (`full`:
    colour, semantics, the consistency loss, the projective correction):
    its whole-map training replayed from captured iterations (the default
    route) and run eagerly (`make_train_loop(_eager=True)`, the loop every
    other route runs). After every frame (frame 0's 60 iterations, 3 and 5
    iterations, the decoder freeze, a capacity growth) the features, the
    decoders, the certainty, the update timestamps, the losses and the
    pose are the same bits; three captures, one for each key (the decoder
    training, frozen, frozen at the grown capacity), and every iteration
    but each frame's first replayed: 71 of 77 (of 74 under `full`, whose
    frame 5 does not train, `test_torch_train_graph.py`)."""
    import train_graph_case as case
    from pin_slam_tpu_torch.utils import tracing

    seq = case.frames(variant)
    tracing.drain()
    tracing.enable()
    try:
        graphed, a = case.run(cuda, seq, variant)
    finally:
        tracing.disable()
    names = [r.name for r in tracing.drain()]
    _, b = case.run(cuda, seq, variant, eager=True)
    torch.cuda.synchronize()
    case.assert_bit_equal(a, b)
    trained = [bool(f["trained"]) for f in a]
    iters = sum(len(f["losses"]) for f, t in zip(a, trained) if t)
    assert iters == (74 if variant == "full" else 77)
    assert names.count("mapper.train") == sum(trained)
    assert names.count("mapper.iter") == iters
    assert names.count("mapper.capture") == 3
    assert names.count("mapper.replay") == iters - sum(trained)
    (g,) = graphed._train_graph.values()
    assert g.graph is not None and g.state.capacity == graphed.state.capacity
