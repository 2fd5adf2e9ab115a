"""The port's own copies of the host-side loop modules against the JAX
package's: the pose-graph solver (slam/pgo.py), the loop detector
(slam/loop_detector.py) and the trajectory metrics (utils/eval_traj.py).
They are numpy/scipy code, so the same seeded inputs give equal outputs
(to 1e-12 where scipy's sparse solve may order its sums differently); the
g2o text differs only in the quaternion digits, which the JAX package
computes through XLA in float32 and the port through numpy in float32
(within 2.4e-7, two float32 ulps at 1)."""

import numpy as np
import pytest

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.slam import loop_detector as jld
from pin_slam_tpu.slam import pgo as jpgo
from pin_slam_tpu.utils import eval_traj as jet
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)
from pin_slam_tpu_torch.slam import loop_detector as tld
from pin_slam_tpu_torch.slam import pgo as tpgo
from pin_slam_tpu_torch.utils import eval_traj as tet


def _cfg(cls, **kw):
    c = cls()
    for k, v in kw.items():
        setattr(c, k, v)
    return c.finalize()


def _rot(axis_angle):
    return tpgo._so3_exp(np.asarray(axis_angle, np.float64))


def _noisy_chain(rng, n):
    """A ground-truth circle-ish chain and an odometry chain with drift."""
    gt = circle_trajectory(n, radius=8.0, revolutions=1.1)
    odom = [gt[0].copy()]
    for i in range(1, n):
        rel = np.linalg.inv(gt[i - 1]) @ gt[i]
        N = np.eye(4)
        N[:3, :3] = _rot(rng.randn(3) * 0.004)
        N[:3, 3] = rng.randn(3) * 0.02
        odom.append(odom[-1] @ rel @ N)
    return gt, np.stack(odom)


def _build_graph(mod, cls, rng_seed, use_cov):
    rng = np.random.RandomState(rng_seed)
    n = 40
    gt, odom = _noisy_chain(rng, n)
    cfg = _cfg(cls, use_reg_cov_mat=use_cov, pgo_freq=10)
    pgm = mod.PoseGraphManager(cfg)
    travel = np.concatenate([[0.0], np.cumsum(np.linalg.norm(
        np.diff(odom[:, :3, 3], axis=0), axis=1))])
    drifts, accepted = [], []
    for i in range(n):
        pgm.add_frame_node(i, odom[i])
        if i == 0:
            continue
        cov = np.diag(rng.uniform(1e-6, 1e-4, 6)) if use_cov else None
        pgm.add_odometry_factor(i, i - 1, np.linalg.inv(odom[i - 1])
                                @ odom[i], cov=cov)
        drifts.append(pgm.estimate_drift(travel, i))
    # one true loop edge, one 7 m off (rejected by the error budget)
    bad = np.linalg.inv(gt[5]) @ gt[n - 2]
    bad[:3, 3] += 4.0
    for cur, loop, T in ((n - 1, 2, np.linalg.inv(gt[2]) @ gt[n - 1]),
                         (n - 2, 5, bad)):
        cov = np.diag(rng.uniform(1e-6, 1e-4, 6)) if use_cov else None
        ok = pgm.add_loop_factor(cur, loop, T, cov=cov)
        ok = ok and pgm.optimize_pose_graph()
        accepted.append(ok)
        if ok:
            pgm.loop_edges.append(np.array([loop, cur]))
            pgm.loop_trans.append(T)
            pgm.last_loop_idx = cur
        drifts.append(pgm.estimate_drift(travel, n - 1))
    return pgm, np.array(drifts), accepted


@pytest.mark.parametrize("use_cov", [False, True])
def test_pose_graph_manager(use_cov):
    jm, jd, ja = _build_graph(jpgo, JConfig, 5, use_cov)
    tm, td, ta = _build_graph(tpgo, TConfig, 5, use_cov)
    assert ja == ta and ja[0] and not ja[1]
    np.testing.assert_array_equal(td, jd)
    assert tm.pgo_count == jm.pgo_count == 1
    np.testing.assert_allclose(tm.pgo_poses, jm.pgo_poses, atol=1e-12,
                               rtol=0)
    np.testing.assert_allclose(tm.get_pose_diff(), jm.get_pose_diff(),
                               atol=1e-12, rtol=0)
    assert abs(tm.last_error - jm.last_error) <= 1e-12 * max(
        1.0, abs(jm.last_error))
    assert len(tm.edges) == len(jm.edges)
    for a, b in zip(tm.edges, jm.edges):
        assert (a["i"], a["j"], a["is_loop"]) == (b["i"], b["j"], b["is_loop"])
        np.testing.assert_array_equal(a["Z"], b["Z"])
        np.testing.assert_array_equal(a["sqrt_w"], b["sqrt_w"])
    # the solve moved the poses toward the truth at the loop
    assert np.linalg.norm(jm.get_pose_diff()[-1, :3, 3]) > 1e-3


def test_write_g2o_and_loops(tmp_path):
    jm, _, _ = _build_graph(jpgo, JConfig, 5, False)
    tm, _, _ = _build_graph(tpgo, TConfig, 5, False)
    jm.write_g2o(str(tmp_path / "j.g2o"))
    tm.write_g2o(str(tmp_path / "t.g2o"))
    jl = (tmp_path / "j.g2o").read_text().splitlines()
    tl = (tmp_path / "t.g2o").read_text().splitlines()
    assert len(jl) == len(tl) == 40 + len(jm.edges)
    for a, b in zip(jl, tl):
        a, b = a.split(), b.split()
        assert len(a) == len(b)
        # tag, ids and translations print alike; quaternions within 2 ulps
        nq = 2 if a[0] == "VERTEX_SE3:QUAT" else 3
        assert a[:nq + 3] == b[:nq + 3]
        np.testing.assert_allclose(np.float64(b[nq + 3:nq + 7]),
                                   np.float64(a[nq + 3:nq + 7]),
                                   atol=2.4e-7, rtol=0)
        assert a[nq + 7:] == b[nq + 7:]
    jm.write_loops(str(tmp_path / "j.txt"))
    tm.write_loops(str(tmp_path / "t.txt"))
    assert (tmp_path / "j.txt").read_text() == \
        (tmp_path / "t.txt").read_text() != ""


def test_offline_pgo_and_read_loops(tmp_path):
    jm, _, _ = _build_graph(jpgo, JConfig, 5, False)
    jm.write_loops(str(tmp_path / "loops.txt"))
    rng = np.random.RandomState(2)
    _, odom = _noisy_chain(rng, 40)
    out = []
    for mod, cls in ((jpgo, JConfig), (tpgo, TConfig)):
        m = mod.PoseGraphManager(_cfg(cls))
        assert m.read_loops(str(tmp_path / "loops.txt"))
        out.append(m.offline_pgo(odom))
    np.testing.assert_allclose(out[1], out[0], atol=1e-12, rtol=0)


def test_so3_helpers():
    rng = np.random.RandomState(0)
    R = np.stack([_rot(rng.randn(3)) for _ in range(50)])
    np.testing.assert_array_equal(tpgo.so3_log_batch(R),
                                  jpgo.so3_log_batch(R))
    phi = rng.randn(50, 3)
    np.testing.assert_array_equal(tpgo._jr_inv_batch(phi),
                                  jpgo._jr_inv_batch(phi))


# ------------------------------------------------------------- detector


@pytest.fixture(scope="module")
def scans():
    """Eight scans of one scene: a lap's positions, the last two revisit
    the first two with a yaw offset."""
    poses = circle_trajectory(8, radius=6.0, revolutions=0.75)
    poses[6] = poses[0].copy()
    poses[7] = poses[1].copy()
    for i, yaw in ((6, 0.6), (7, -0.4)):
        c, s = np.cos(yaw), np.sin(yaw)
        poses[i][:3, :3] = poses[i][:3, :3] @ np.array(
            [[c, -s, 0], [s, c, 0], [0, 0, 1]])
        poses[i][:2, 3] += [0.3, -0.2]
    seq = SyntheticSequence(scene_sdf=default_scene(), poses=poses,
                            dirs=lidar_directions(256, 16), max_range=60.0)
    return poses, [seq.frame(i) for i in range(8)]


def _ptcloud_world(frame, pose):
    return frame @ pose[:3, :3].T + pose[:3, 3]


@pytest.mark.parametrize("context,feature", [(False, False), (True, False),
                                             (True, True)])
def test_scan_context_manager(scans, context, feature):
    """add_node, detect_local_loop, detect_global_loop (plain, map context
    with virtual nodes, feature context) give equal outputs."""
    poses, frames = scans
    rng = np.random.RandomState(4)
    feats = [rng.randn(len(f), 8).astype(np.float32) for f in frames]
    res = []
    for mod, cls in ((jld, JConfig), (tld, TConfig)):
        cfg = _cfg(cls, local_map_context=context, loop_with_feature=feature,
                   npmc_max_dist=40.0, context_virtual_side_count=2,
                   context_virtual_step_m=1.2)
        m = mod.ScanContextManager(cfg)
        out = []
        for i, f in enumerate(frames):
            m.add_node(i, f, feats[i] if feature else None,
                       valid_flag=(i != 3))
            if i < 6:
                continue
            cand = np.arange(i + 1) < 4
            lid, dist, T = mod.detect_local_loop(
                poses[: i + 1], cand, 0.5, i, 0, 2.0, 6.0)
            out.append((lid, dist, T))
            g = m.detect_global_loop(
                poses[: i + 1], 20.0, cand,
                context_pc_global=(_ptcloud_world(f, poses[i])
                                   if context else None),
                context_features=feats[i] if feature else None)
            out.append(g)
            out.append([np.array(q) for q in m.query_contexts])
            out.append([np.array(t) for t in m.tran_from_frame])
        out.append({k: m.contexts[k] for k in m.contexts})
        out.append({k: m.ringkeys_feature[k] for k in m.ringkeys_feature})
        out.append(dict(m.valid_flags))
        res.append(out)
    jo, to = res
    assert len(jo) == len(to)
    found = 0
    for a, b in zip(jo, to):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(b[k], a[k])
        elif isinstance(a, list):
            assert len(a) == len(b)
            for x, y in zip(a, b):
                np.testing.assert_array_equal(y, x)
        else:
            assert len(a) == len(b) == 3
            assert a[0] == b[0] and a[1] == b[1]
            found += a[0] is not None
            if a[2] is not None:
                np.testing.assert_array_equal(b[2], a[2])
    assert found > 0


def test_virtual_nodes_and_feature_distance(scans):
    poses, frames = scans
    rng = np.random.RandomState(1)
    f = rng.randn(len(frames[6]), 8)
    out = []
    for mod, cls in ((jld, JConfig), (tld, TConfig)):
        m = mod.ScanContextManager(_cfg(cls, context_virtual_side_count=3,
                                        context_virtual_step_m=0.9))
        m.add_node(6, frames[6], f)
        m.set_virtual_nodes(_ptcloud_world(frames[6], poses[6]), poses[6],
                            poses[5], features=f)
        sc = mod.ptcloud2sc_feature(frames[0], rng.randn(len(frames[0]), 8),
                                    (20, 60), 40.0)
        out.append((m.query_contexts, m.tran_from_frame,
                    mod.distance_sc_feature(m.query_contexts[1], sc),
                    mod.distance_sc(mod.ptcloud2sc(frames[0], (20, 60), 40.0),
                                    mod.ptcloud2sc(frames[6], (20, 60),
                                                   40.0))))
        rng = np.random.RandomState(1)
        f = rng.randn(len(frames[6]), 8)
    (jq, jt, jdf, jd), (tq, tt, tdf, td) = out
    assert len(jq) == len(tq) == 7
    for a, b in zip(jq + jt, tq + tt):
        np.testing.assert_array_equal(b, a)
    assert jdf == tdf and jd == td


def test_gt_loop_manager():
    poses = circle_trajectory(60, radius=8.0, revolutions=1.2)
    out = []
    for mod in (jld, tld):
        m = mod.GTLoopManager(max_loop_dist=3.0, exclude_recent_nodes=10,
                              min_travel_dist=20.0)
        hits = []
        for i, p in enumerate(poses):
            m.add_node(i, p)
            hits.append(m.detect_loop())
        out.append(hits)
    found = 0
    for a, b in zip(*out):
        assert a[0] == b[0] and a[1] == b[1]
        if a[2] is not None:
            found += 1
            np.testing.assert_array_equal(b[2], a[2])
    assert found > 0


# ------------------------------------------------------------- metrics


def test_get_metrics():
    rng = np.random.RandomState(3)
    gt, odom = _noisy_chain(rng, 300)
    gt = gt.copy()
    gt[:, :3, 3] *= 8.0            # segments of 100+ m for the drift terms
    odom[:, :3, 3] *= 8.0
    for align in (True, False):
        a = jet.get_metrics(gt, odom, align)
        b = tet.get_metrics(gt, odom, align)
        assert a == b
        assert a["Average Translation Error [%]"] > 0
    assert tet.mean_metrics([a, b]) == jet.mean_metrics([a, b])
    np.testing.assert_array_equal(tet.relative_error(gt, odom),
                                  jet.relative_error(gt, odom))
