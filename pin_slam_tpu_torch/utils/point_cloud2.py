"""ROS PointCloud2 <-> NumPy conversion (pure NumPy, no ROS needed).

Rebuilds reference utils/point_cloud2.py:1-186: structured-dtype parsing of
sensor_msgs/PointCloud2 byte buffers, and message construction for
publishing. Works with any object exposing the PointCloud2 attributes
(fields, point_step, row_step, data, width, height, is_bigendian), so it is
unit-testable without rospy.

The port's own copy of `pin_slam_tpu/utils/point_cloud2.py`.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

# sensor_msgs/PointField datatype constants
INT8, UINT8, INT16, UINT16, INT32, UINT32, FLOAT32, FLOAT64 = range(1, 9)

_DATATYPES = {
    INT8: "i1", UINT8: "u1", INT16: "i2", UINT16: "u2",
    INT32: "i4", UINT32: "u4", FLOAT32: "f4", FLOAT64: "f8",
}


def fields_to_dtype(fields, point_step: int, is_bigendian: bool = False):
    """Structured numpy dtype from PointField list."""
    prefix = ">" if is_bigendian else "<"
    names, formats, offsets = [], [], []
    for f in fields:
        base = _DATATYPES[f.datatype]
        count = getattr(f, "count", 1) or 1
        names.append(f.name)
        formats.append(f"{prefix}{base}" if count == 1
                       else (count, f"{prefix}{base}"))
        offsets.append(f.offset)
    return np.dtype({"names": names, "formats": formats,
                     "offsets": offsets, "itemsize": point_step})


def read_point_cloud2(
    msg, min_intensity: float = -1.0
) -> Tuple[np.ndarray, Optional[np.ndarray], Optional[np.ndarray]]:
    """PointCloud2 -> (points [N,3] f64, point_ts [N] or None,
    intensity [N] or None). NaN rows dropped
    (reference: utils/point_cloud2.py read_point_cloud)."""
    dt = fields_to_dtype(msg.fields, msg.point_step,
                         getattr(msg, "is_bigendian", False))
    arr = np.frombuffer(bytes(msg.data), dt,
                        count=msg.width * msg.height)
    pts = np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float64)
    names = dt.names
    ts = None
    for tf in ("t", "ts", "time", "timestamp", "timestamps", "time_offset"):
        if tf in names:
            ts = np.asarray(arr[tf], np.float64)
            rng = ts.max() - ts.min()
            ts = (ts - ts.min()) / rng if rng > 0 else None
            break
    intensity = (np.asarray(arr["intensity"], np.float64)
                 if "intensity" in names else None)
    ok = np.isfinite(pts).all(axis=1)
    if min_intensity >= 0 and intensity is not None:
        ok &= intensity >= min_intensity
    pts = pts[ok]
    if ts is not None:
        ts = ts[ok]
    if intensity is not None:
        intensity = intensity[ok]
    return pts, ts, intensity


class _Field:
    def __init__(self, name, offset, datatype, count=1):
        self.name, self.offset, self.datatype, self.count = \
            name, offset, datatype, count


class SimplePointCloud2:
    """Minimal PointCloud2-shaped container for tests and for publishing
    through rospy (converted by the ROS node)."""

    def __init__(self, points: np.ndarray,
                 intensity: Optional[np.ndarray] = None):
        n = points.shape[0]
        fields = [_Field("x", 0, FLOAT32), _Field("y", 4, FLOAT32),
                  _Field("z", 8, FLOAT32)]
        step = 12
        if intensity is not None:
            fields.append(_Field("intensity", 12, FLOAT32))
            step = 16
        dt = fields_to_dtype(fields, step)
        arr = np.zeros(n, dt)
        arr["x"], arr["y"], arr["z"] = (
            points[:, 0].astype(np.float32),
            points[:, 1].astype(np.float32),
            points[:, 2].astype(np.float32))
        if intensity is not None:
            arr["intensity"] = intensity.astype(np.float32)
        self.fields = fields
        self.point_step = step
        self.width = n
        self.height = 1
        self.row_step = step * n
        self.is_bigendian = False
        self.data = arr.tobytes()


def make_point_cloud2(points: np.ndarray, frame_id: str = "map",
                      stamp=None):
    """Build a real sensor_msgs/PointCloud2 for publishing (requires rospy;
    reference: pin_slam_ros.py map/frame publishing :344-380)."""
    from sensor_msgs.msg import PointCloud2, PointField

    simple = SimplePointCloud2(np.asarray(points, np.float32))
    msg = PointCloud2()
    if stamp is not None:
        msg.header.stamp = stamp
    msg.header.frame_id = frame_id
    msg.height = 1
    msg.width = simple.width
    msg.fields = [
        PointField(name=f.name, offset=f.offset, datatype=f.datatype,
                   count=1) for f in simple.fields]
    msg.is_bigendian = False
    msg.point_step = simple.point_step
    msg.row_step = simple.row_step
    msg.data = simple.data
    msg.is_dense = True
    return msg
