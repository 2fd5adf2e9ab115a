#!/usr/bin/env python3
"""ROS1 node: online SLAM driven by a PointCloud2 subscriber. The port's
counterpart of `pin_slam_tpu/pin_slam_ros.py`.

Rebuilds reference pin_slam_ros.py:52-401 (class PINSLAMer): the frame
callback runs the full per-frame SLAM step on the card, publishes
odometry, TF and path and the neural point map, exposes save services, and
exits after a topic timeout.

rospy, nav_msgs, geometry_msgs, sensor_msgs, tf2_ros and std_srvs are
imported lazily, so the rest of the port stays usable without a ROS
installation; the PointCloud2 parsing is the port's own numpy code
(utils/point_cloud2.py) and the published quaternion is computed on the
host (`ops/transforms.np_rotmat_to_quat`), with no device call per
message.

    python -m pin_slam_tpu_torch.pin_slam_ros <config.yaml> [topic]
"""

from __future__ import annotations

import os
import time

import numpy as np

from pin_slam_tpu_torch.config import Config
from pin_slam_tpu_torch.ops.transforms import np_rotmat_to_quat
from pin_slam_tpu_torch.utils.point_cloud2 import read_point_cloud2


class PINSLAMRosNode:
    """`device`: where the system runs (None: the card, raising without
    one; tests pass "cpu")."""

    def __init__(self, config: Config, point_cloud_topic: str = "/points",
                 device=None):
        try:
            import rospy  # noqa: F401
        except ImportError as e:
            raise ImportError(
                "rospy is required for the ROS node; run the offline CLI "
                "(python -m pin_slam_tpu_torch.run) instead") from e
        import rospy
        from nav_msgs.msg import Odometry, Path
        from sensor_msgs.msg import PointCloud2

        from pin_slam_tpu_torch.slam.loop import LoopPgoManager
        from pin_slam_tpu_torch.slam.system import PinSLAMSystem

        self.rospy = rospy
        self.config = config
        self.system = PinSLAMSystem(config, device=device)
        self.loop_mgr = (LoopPgoManager(config, self.system)
                         if config.pgo_on else None)
        self.frame_id = 0
        self.last_msg_time = time.time()
        self.last_frame_points = None

        rospy.init_node("pin_slam_tpu")
        self.odom_pub = rospy.Publisher("~odometry", Odometry, queue_size=10)
        self.path_pub = rospy.Publisher("~path", Path, queue_size=2)
        self.map_pub = rospy.Publisher("~neural_points", PointCloud2,
                                       queue_size=2)
        self.frame_pub = rospy.Publisher("~frame", PointCloud2, queue_size=2)
        rospy.Subscriber(point_cloud_topic, PointCloud2,
                         self.frame_callback, queue_size=5)
        rospy.Timer(rospy.Duration(1.0), self.check_exit)
        self.path_msgs = []
        self.map_frame = "map"
        self.sensor_frame = "sensor"
        # TF broadcast (reference: pin_slam_ros.py:132-133,330-340)
        try:
            import tf2_ros
            self.tf_broadcaster = tf2_ros.TransformBroadcaster()
        except ImportError:
            self.tf_broadcaster = None
        # save services (reference: pin_slam_ros.py:132-133)
        try:
            from std_srvs.srv import Trigger, TriggerResponse
            self._TriggerResponse = TriggerResponse
            rospy.Service("~save_results", Trigger, self.srv_save_results)
            rospy.Service("~save_mesh", Trigger, self.srv_save_mesh)
        except ImportError:
            pass
        # adaptive map publish rate (reference :364-368)
        self.map_pub_freq = 10

    # ------------------------------------------------------------- callback

    def frame_callback(self, msg):
        """(reference: pin_slam_ros.py:165-256)"""
        self.last_msg_time = time.time()
        points, point_ts, intensity = read_point_cloud2(msg)
        if points.shape[0] < 10:
            return
        self.last_frame_points = points[:, :3]
        hook = None
        if self.loop_mgr is not None:
            hook = lambda fid, _p=points: self.loop_mgr.after_frame(fid, _p)
        pose = self.system.process_frame(
            self.frame_id, points, point_ts=point_ts, loop_hook=hook)
        self.publish_msg(pose, msg)
        self.frame_id += 1

    def publish_msg(self, pose: np.ndarray, src_msg):
        """(reference: pin_slam_ros.py:292-401)"""
        import rospy
        from geometry_msgs.msg import PoseStamped
        from nav_msgs.msg import Odometry, Path

        stamp = src_msg.header.stamp if hasattr(src_msg, "header") \
            else rospy.Time.now()
        odom = Odometry()
        odom.header.stamp = stamp
        odom.header.frame_id = "map"
        odom.pose.pose.position.x = pose[0, 3]
        odom.pose.pose.position.y = pose[1, 3]
        odom.pose.pose.position.z = pose[2, 3]
        q = np_rotmat_to_quat(pose[:3, :3])
        odom.pose.pose.orientation.w = float(q[0])
        odom.pose.pose.orientation.x = float(q[1])
        odom.pose.pose.orientation.y = float(q[2])
        odom.pose.pose.orientation.z = float(q[3])
        self.odom_pub.publish(odom)

        ps = PoseStamped()
        ps.header = odom.header
        ps.pose = odom.pose.pose
        self.path_msgs.append(ps)
        path = Path()
        path.header = odom.header
        path.poses = self.path_msgs[-1000:]
        self.path_pub.publish(path)

        # TF map -> sensor (reference: pin_slam_ros.py:330-340)
        if self.tf_broadcaster is not None:
            from geometry_msgs.msg import TransformStamped
            t = TransformStamped()
            t.header.stamp = stamp
            t.header.frame_id = self.map_frame
            t.child_frame_id = self.sensor_frame
            t.transform.translation.x = pose[0, 3]
            t.transform.translation.y = pose[1, 3]
            t.transform.translation.z = pose[2, 3]
            t.transform.rotation.w = float(q[0])
            t.transform.rotation.x = float(q[1])
            t.transform.rotation.y = float(q[2])
            t.transform.rotation.z = float(q[3])
            self.tf_broadcaster.sendTransform(t)

        # neural-point map publishing at an adaptive rate
        # (reference: pin_slam_ros.py:344-380)
        if self.frame_id % self.map_pub_freq == 0:
            from pin_slam_tpu_torch.utils.point_cloud2 import (
                make_point_cloud2)
            cnt = int(self.system.state.count)
            if cnt > 0:
                # decimate to bound message size; slow the rate as the
                # map grows (reference's adaptive down rate)
                step = max(1, cnt // 200_000)
                pts = self.system.state.positions[:cnt:step].cpu().numpy()
                self.map_pub.publish(make_point_cloud2(
                    pts, self.map_frame, stamp))
                if cnt > 1_000_000:
                    self.map_pub_freq = 50
        # registered current frame
        if self.last_frame_points is not None:
            from pin_slam_tpu_torch.utils.point_cloud2 import (
                make_point_cloud2)
            w = (self.last_frame_points[::5] @ pose[:3, :3].T
                 + pose[:3, 3])
            self.frame_pub.publish(make_point_cloud2(
                w, self.map_frame, stamp))

    # ---------------------------------------------------------- services

    def _run_path(self) -> str:
        run_path = self.config.run_path or "./experiments/ros_run"
        os.makedirs(run_path, exist_ok=True)
        return run_path

    def srv_save_results(self, _req):
        """(reference: pin_slam_ros.py save_results service)"""
        from pin_slam_tpu_torch.dataset.io import write_kitti_format_poses
        from pin_slam_tpu_torch.utils.map_io import save_implicit_map

        run_path = self._run_path()
        write_kitti_format_poses(
            os.path.join(run_path, "odom_poses_kitti.txt"),
            self.system.odom_poses[:self.frame_id])
        save_implicit_map(os.path.join(run_path, "pin_map.npz"),
                          self.system.state, self.system.params, self.config)
        return self._TriggerResponse(
            success=True, message=f"results saved to {run_path}")

    def srv_save_mesh(self, _req):
        """(reference: pin_slam_ros.py save_mesh service)"""
        from pin_slam_tpu_torch.slam.mesher import MeshConfig, Mesher, write_ply

        run_path = self._run_path()
        mesher = Mesher(self.system.qp, MeshConfig(
            mc_res_m=self.config.mc_res_m,
            mesh_min_nn=self.config.mesh_min_nn), mesh=self.system.mesh)
        verts, faces = mesher.recon_map_mesh(
            self.system.state, self.system.params["geo_features"],
            self.system.params["geo_mlp"])
        path = os.path.join(run_path, "mesh_ros.ply")
        write_ply(path, verts, faces)
        return self._TriggerResponse(success=True,
                                     message=f"mesh saved to {path}")

    def check_exit(self, _evt=None):
        """Auto-exit after silence (reference: pin_slam_ros.py:258-270)."""
        if time.time() - self.last_msg_time > self.config.timeout_duration_s:
            self.rospy.signal_shutdown("no point cloud received, exiting")

    def spin(self):
        self.rospy.spin()


def main(argv=None):
    import argparse

    p = argparse.ArgumentParser()
    p.add_argument("config_path")
    p.add_argument("topic", nargs="?", default="/points")
    a = p.parse_args(argv)
    config = Config().load(a.config_path)
    config.finalize()
    node = PINSLAMRosNode(config, a.topic)
    node.spin()


if __name__ == "__main__":
    main()
