"""The port's ROS1 node (pin_slam_tpu_torch.pin_slam_ros.PINSLAMRosNode)
against the JAX package's, on the CPU, through stand-in rospy, nav_msgs,
geometry_msgs, sensor_msgs, tf2_ros and std_srvs modules defined here
(neither ROS nor its message packages are installed).

Both nodes get the same three PointCloud2 messages of a synthetic scan
sequence through their frame callbacks. Each odometry message the port
publishes carries the system's pose and the quaternion of
`np_rotmat_to_quat`; the TF and the path carry the same; the map and the
registered frame are published as PointCloud2. The two nodes' poses agree
within test_torch_run.py's 0.3 m bound and lie within it of ground truth
(relative to the first frame: a node starts at the identity).
The save services write a pin_map.npz that `load_implicit_map` reads back
equal to the map, the odometry, and a mesh.
"""

import sys
import types

import numpy as np
import pytest
import torch

from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence,
    circle_trajectory,
    default_scene,
    lidar_directions,
)
from pin_slam_tpu_torch.ops.transforms import np_rotmat_to_quat
from pin_slam_tpu_torch.utils.point_cloud2 import SimplePointCloud2

N_FRAMES = 3
POSE_BOUND_M = 0.3          # test_torch_run.py's ATE bound


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One torch thread: the test workers share the machine's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


class Msg:
    """A ROS message stand-in: keyword fields, nested fields made on first
    access."""

    def __init__(self, **kw):
        self.__dict__.update(kw)

    def __getattr__(self, name):
        if name.startswith("__"):
            raise AttributeError(name)
        v = Msg()
        setattr(self, name, v)
        return v


def ros_stubs(log):
    """Stand-in ROS modules; every publish, TF and service goes to `log`."""
    rospy = types.ModuleType("rospy")

    class Publisher:
        def __init__(self, name, kind, queue_size=1):
            self.name = name
            log.setdefault(name, [])

        def publish(self, msg):
            log[self.name].append(msg)

    def subscriber(topic, kind, callback, queue_size=1):
        log["callback"] = callback

    def service(name, kind, handler):
        log.setdefault("services", {})[name] = handler

    rospy.init_node = lambda name: log.setdefault("node", name)
    rospy.Publisher = Publisher
    rospy.Subscriber = subscriber
    rospy.Service = service
    rospy.Timer = lambda period, fn: None
    rospy.Duration = lambda s: s
    rospy.Time = types.SimpleNamespace(now=lambda: 0.0)
    rospy.signal_shutdown = lambda why: log.setdefault("shutdown", why)
    rospy.spin = lambda: None

    def msg_module(name, *kinds):
        mod = types.ModuleType(name)
        for k in kinds:
            setattr(mod, k, type(k, (Msg,), {}))
        return mod

    class Broadcaster:
        def sendTransform(self, t):
            log.setdefault("tf", []).append(t)

    tf2 = types.ModuleType("tf2_ros")
    tf2.TransformBroadcaster = Broadcaster
    mods = {"rospy": rospy, "tf2_ros": tf2}
    for pkg, sub, kinds in (
            ("nav_msgs", "msg", ("Odometry", "Path")),
            ("geometry_msgs", "msg", ("PoseStamped", "TransformStamped")),
            ("sensor_msgs", "msg", ("PointCloud2", "PointField")),
            ("std_srvs", "srv", ("Trigger", "TriggerResponse"))):
        mods[pkg] = types.ModuleType(pkg)
        mods[f"{pkg}.{sub}"] = msg_module(f"{pkg}.{sub}", *kinds)
        setattr(mods[pkg], sub, mods[f"{pkg}.{sub}"])
    return mods


def small_config(cls, run_path):
    cfg = cls()
    cfg.track_on = True
    cfg.max_range = 60.0
    cfg.min_range = 0.5
    cfg.vox_down_m = 0.08
    cfg.source_vox_down_m = 0.4
    cfg.voxel_size_m = 0.3
    cfg.sigma_sigmoid_m = 0.1
    cfg.surface_sample_range_m = 0.25
    cfg.loss_weight_on = True
    cfg.bs = 512
    cfg.iters = 3
    cfg.init_iter_ratio = 100
    cfg.bs_new_sample = 128
    cfg.reg_iter_n = 20
    cfg.map_capacity = 1 << 16
    cfg.buffer_size = 1 << 18
    cfg.frame_point_cap = 1 << 13
    cfg.source_point_cap = 1 << 11
    cfg.max_frames = 16
    cfg.probe_mode = "cells"
    cfg.mc_res_m = 0.5
    cfg.mesh_min_nn = 6
    cfg.finalize()
    cfg.pool_capacity = 200_000
    cfg.run_path = str(run_path)
    return cfg


@pytest.fixture(scope="module")
def nodes(tmp_path_factory):
    from pin_slam_tpu.config import Config as JConfig
    from pin_slam_tpu.pin_slam_ros import PINSLAMRosNode as JNode
    from pin_slam_tpu_torch.config import Config as TConfig
    from pin_slam_tpu_torch.pin_slam_ros import PINSLAMRosNode as TNode

    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N_FRAMES + 1, radius=6.0, revolutions=0.03,
                                ease_in_frames=4),
        dirs=lidar_directions(512, 32), max_range=60.0)
    msgs = []
    for i in range(N_FRAMES):
        m = SimplePointCloud2(seq.frame(i))
        m.header = Msg(stamp=float(i), frame_id="velodyne")
        msgs.append(m)
    out = {"seq": seq}
    root = tmp_path_factory.mktemp("ros")
    saved = {k: sys.modules.get(k) for k in ros_stubs({})}
    try:
        for tag, cls, Node, kw in (("jax", JConfig, JNode, {}),
                                   ("torch", TConfig, TNode,
                                    {"device": "cpu"})):
            log = {}
            sys.modules.update(ros_stubs(log))
            node = Node(small_config(cls, root / tag), "/points", **kw)
            if tag == "torch":
                # the port's node starts from the JAX node's decoder
                import jax
                from pin_slam_tpu_torch import convert
                node.system.params["geo_mlp"] = convert.mlp_from_numpy(
                    jax.tree.map(np.asarray,
                                 out["jax"][0].system.params["geo_mlp"]),
                    device="cpu")
            poses = []
            for m in msgs:
                log["callback"](m)
                poses.append(node.system.cur_pose_ref.copy())
            out[tag] = (node, log, poses)
    finally:
        for k, v in saved.items():
            if v is None:
                sys.modules.pop(k, None)
            else:
                sys.modules[k] = v
    return out


def test_published_odometry_is_the_systems_pose(nodes):
    node, log, poses = nodes["torch"]
    odom = log["~odometry"]
    assert node.frame_id == len(odom) == N_FRAMES
    for o, T, m in zip(odom, poses, range(N_FRAMES)):
        assert o.header.stamp == float(m) and o.header.frame_id == "map"
        p = o.pose.pose.position
        assert (p.x, p.y, p.z) == tuple(T[:3, 3])
        q = o.pose.pose.orientation
        assert [q.w, q.x, q.y, q.z] == [float(v) for v in
                                        np_rotmat_to_quat(T[:3, :3])]
    for t, o in zip(log["tf"], odom):
        r = t.transform.rotation
        assert (r.w, r.x, r.y, r.z) == (o.pose.pose.orientation.w,
                                        o.pose.pose.orientation.x,
                                        o.pose.pose.orientation.y,
                                        o.pose.pose.orientation.z)
    assert len(log["~path"][-1].poses) == N_FRAMES
    # the map on frame 0 (every 10th frame), the registered scan each frame
    assert len(log["~neural_points"]) == 1 and len(log["~frame"]) == N_FRAMES
    cloud = log["~neural_points"][0]
    assert 1000 < cloud.width <= int(node.system.state.count)
    assert cloud.point_step == 12 and len(cloud.data) == 12 * cloud.width


def test_poses_agree_with_the_jax_node(nodes):
    """Both nodes start at the identity: the truth is the sequence's poses
    relative to its first."""
    seq = nodes["seq"]
    (_, _, jp), (tnode, _, tp) = nodes["jax"], nodes["torch"]
    for i in range(N_FRAMES):
        gt = np.linalg.inv(seq.poses[0]) @ seq.poses[i]
        assert np.linalg.norm(tp[i][:3, 3] - jp[i][:3, 3]) < POSE_BOUND_M
        assert np.linalg.norm(tp[i][:3, 3] - gt[:3, 3]) < POSE_BOUND_M
        assert np.linalg.norm(jp[i][:3, 3] - gt[:3, 3]) < POSE_BOUND_M
    assert bool(tnode.system.last_tracking.valid)


def test_save_services(nodes, tmp_path):
    from pin_slam_tpu_torch.dataset.io import read_kitti_format_poses
    from pin_slam_tpu_torch.utils.map_io import load_implicit_map

    node, log, poses = nodes["torch"]
    res = log["services"]["~save_results"](None)
    assert res.success
    run = node.config.run_path
    st, dec, _ = load_implicit_map(f"{run}/pin_map.npz", device="cpu")
    cnt = int(node.system.state.count)
    assert int(st.count) == cnt
    for f in ("positions", "geo_features", "ts_create", "certainty"):
        np.testing.assert_array_equal(
            getattr(st, f)[:cnt].numpy(),
            getattr(node.system.state, f)[:cnt].numpy(), err_msg=f)
    for a, b in zip(dec["geo_mlp"]["w"], node.system.params["geo_mlp"]["w"]):
        np.testing.assert_array_equal(a.numpy(), b.numpy())
    odom = read_kitti_format_poses(f"{run}/odom_poses_kitti.txt")
    assert len(odom) == N_FRAMES
    assert log["services"]["~save_mesh"](None).success
    import os
    assert os.path.getsize(f"{run}/mesh_ros.ply") > 0
