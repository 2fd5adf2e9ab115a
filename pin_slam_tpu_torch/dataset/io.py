"""Point-cloud / pose / calibration file IO (host-side NumPy, no Open3D).
The port's own copy of `pin_slam_tpu/dataset/io.py`.

Rebuilds the reference readers (reference: dataset/slam_dataset.py:990-1180)
with an in-repo PLY parser replacing Open3D: KITTI .bin, ascii/binary .ply,
.pcd (ascii + binary), .npy; KITTI & TUM pose formats; KITTI calib.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

_PLY_DTYPES = {
    "char": "i1", "uchar": "u1", "short": "i2", "ushort": "u2",
    "int": "i4", "uint": "u4", "int8": "i1", "uint8": "u1",
    "int16": "i2", "uint16": "u2", "int32": "i4", "uint32": "u4",
    "float": "f4", "float32": "f4", "float64": "f8", "double": "f8",
}

TIME_FIELDS = ("t", "ts", "time", "timestamp", "timestamps")


def read_ply(filename: str):
    """Parse a PLY file's vertex element into a dict of numpy arrays.
    Supports ascii and binary_little_endian, list-free vertex properties."""
    with open(filename, "rb") as f:
        if f.readline().strip() != b"ply":
            raise ValueError(f"{filename}: not a ply file")
        fmt = None
        elems = []  # (name, count, [(prop_name, dtype_str)])
        while True:
            line = f.readline().strip().decode("ascii", "ignore")
            if line.startswith("format"):
                fmt = line.split()[1]
            elif line.startswith("comment"):
                continue
            elif line.startswith("element"):
                _, name, cnt = line.split()
                elems.append((name, int(cnt), []))
            elif line.startswith("property"):
                parts = line.split()
                if parts[1] == "list":
                    elems[-1][2].append((parts[-1], "list",
                                         parts[2], parts[3]))
                else:
                    elems[-1][2].append((parts[2], _PLY_DTYPES[parts[1]]))
            elif line == "end_header":
                break

        out = {}
        for name, cnt, props in elems:
            if name == "vertex":
                if fmt == "ascii":
                    rows = np.loadtxt(
                        [f.readline() for _ in range(cnt)], ndmin=2)
                    for i, p in enumerate(props):
                        out[p[0]] = rows[:, i]
                else:
                    endian = "<" if "little" in fmt else ">"
                    dt = np.dtype(
                        [(p[0], endian + p[1]) for p in props])
                    arr = np.frombuffer(f.read(cnt * dt.itemsize), dt)
                    for p in props:
                        out[p[0]] = np.ascontiguousarray(arr[p[0]])
            else:
                # skip non-vertex elements (faces etc.) — best effort for
                # ascii; binary requires walking lists, rarely needed here
                if fmt == "ascii":
                    for _ in range(cnt):
                        f.readline()
                else:
                    break
        return out


def read_pcd(filename: str) -> np.ndarray:
    """Minimal PCD reader (ascii + binary)."""
    with open(filename, "rb") as f:
        header = {}
        while True:
            line = f.readline().decode("ascii", "ignore").strip()
            if line.startswith("#"):
                continue
            key, _, val = line.partition(" ")
            header[key.upper()] = val
            if key.upper() == "DATA":
                break
        fields = header["FIELDS"].split()
        sizes = list(map(int, header["SIZE"].split()))
        types = header["TYPE"].split()
        counts = list(map(int, header.get(
            "COUNT", " ".join(["1"] * len(fields))).split()))
        n = int(header["POINTS"])
        tmap = {("F", 4): "f4", ("F", 8): "f8", ("U", 1): "u1",
                ("U", 2): "u2", ("U", 4): "u4", ("I", 1): "i1",
                ("I", 2): "i2", ("I", 4): "i4"}
        if header["DATA"] == "ascii":
            rows = np.loadtxt([f.readline() for _ in range(n)], ndmin=2)
            idx = {fl: i for i, fl in enumerate(fields)}
            return rows[:, [idx["x"], idx["y"], idx["z"]]]
        dt = np.dtype([
            (fl, f"<{tmap[(t, s)]}", (c,)) if c > 1 else (fl, f"<{tmap[(t, s)]}")
            for fl, s, t, c in zip(fields, sizes, types, counts)])
        arr = np.frombuffer(f.read(n * dt.itemsize), dt, count=n)
        return np.stack([arr["x"], arr["y"], arr["z"]], -1).astype(np.float64)


def read_point_cloud(
    filename: str, color_channel: int = 0, bin_channel_count: int = 4
) -> Tuple[np.ndarray, Optional[np.ndarray]]:
    """Load points [N,3(+c)] + optional per-point timestamps
    (reference: dataset/slam_dataset.py:990-1055)."""
    ts = None
    if filename.endswith(".bin"):
        data = np.fromfile(filename, dtype=np.float32)
        points = data.reshape(-1, bin_channel_count)
        if color_channel == 1 and bin_channel_count >= 4:
            points = points[:, :4]
        else:
            points = points[:, :3]
    elif filename.endswith(".ply"):
        d = read_ply(filename)
        if "x" in d:
            points = np.stack([d["x"], d["y"], d["z"]], -1)
        else:
            raise ValueError(f"{filename}: no x/y/z vertex properties")
        for tf in TIME_FIELDS:
            if tf in d:
                ts = np.asarray(d[tf], np.float64)
                break
        if color_channel == 3 and all(k in d for k in ("red", "green", "blue")):
            cols = np.stack([d["red"], d["green"], d["blue"]], -1)
            if cols.max() > 1.0:
                cols = cols / 255.0
            points = np.hstack([points, cols])
        elif color_channel == 1 and "intensity" in d:
            points = np.hstack([points, d["intensity"][:, None]])
    elif filename.endswith(".pcd"):
        points = read_pcd(filename)
    elif filename.endswith(".npy"):
        points = np.load(filename)
    else:
        raise ValueError(f"unsupported point cloud format: {filename}")
    return np.asarray(points, np.float64), ts


def read_kitti_format_calib(filename: str) -> dict:
    """(reference: dataset/slam_dataset.py:1095-1116)"""
    calib = {}
    with open(filename) as f:
        for line in f:
            if ":" not in line:
                continue
            key, content = line.strip().split(":", 1)
            values = [float(v) for v in content.strip().split()]
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            calib[key] = pose
    return calib


def read_kitti_format_poses(filename: str) -> Optional[List[np.ndarray]]:
    """(reference: dataset/slam_dataset.py:1119-1140)"""
    poses = []
    with open(filename) as f:
        for line in f:
            values = [float(v) for v in line.strip().split()]
            if len(values) < 12:
                return None
            pose = np.zeros((4, 4))
            pose[0, :4] = values[0:4]
            pose[1, :4] = values[4:8]
            pose[2, :4] = values[8:12]
            pose[3, 3] = 1.0
            poses.append(pose)
    return poses


def _quat_to_rot(qw, qx, qy, qz) -> np.ndarray:
    n = np.sqrt(qw**2 + qx**2 + qy**2 + qz**2)
    qw, qx, qy, qz = qw / n, qx / n, qy / n, qz / n
    return np.array([
        [1 - 2 * (qy**2 + qz**2), 2 * (qx * qy - qw * qz),
         2 * (qx * qz + qw * qy)],
        [2 * (qx * qy + qw * qz), 1 - 2 * (qx**2 + qz**2),
         2 * (qy * qz - qw * qx)],
        [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
         1 - 2 * (qx**2 + qy**2)],
    ])


def read_tum_format_poses(filename: str):
    """# timestamp tx ty tz qx qy qz qw
    (reference: dataset/slam_dataset.py:1142-1179)"""
    poses, timestamps = [], []
    with open(filename) as f:
        lines = f.readlines()
    for line in lines:
        if line.startswith("#"):
            continue
        values = line.strip().split()
        if len(values) not in (8, 9):
            continue
        off = len(values) - 8
        v = [float(x) for x in values]
        timestamps.append(v[off])
        T = np.eye(4)
        T[:3, 3] = v[1 + off: 4 + off]
        T[:3, :3] = _quat_to_rot(v[7 + off], v[4 + off], v[5 + off], v[6 + off])
        poses.append(T)
    return poses, timestamps


def apply_kitti_format_calib(poses: List[np.ndarray],
                             calib_T_cl: np.ndarray) -> List[np.ndarray]:
    """Convert from camera to LiDAR frame: T_l = T_cl^-1 T_c T_cl."""
    inv = np.linalg.inv(calib_T_cl)
    return [inv @ p @ calib_T_cl for p in poses]


def write_kitti_format_poses(filename: str, poses: np.ndarray):
    """(reference writes poses flattened 3x4 per line)"""
    with open(filename, "w") as f:
        for T in poses:
            f.write(" ".join(f"{v:.9f}" for v in T[:3, :4].reshape(-1)) + "\n")


def write_tum_format_poses(filename: str, poses: np.ndarray,
                           timestamps=None, frame_rate: float = 10.0):
    """# timestamp tx ty tz qx qy qz qw, the quaternion computed in float32
    as the JAX package computes it."""
    from pin_slam_tpu_torch.ops.transforms import np_rotmat_to_quat

    with open(filename, "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for i, T in enumerate(poses):
            ts = timestamps[i] if timestamps is not None else i / frame_rate
            q = np_rotmat_to_quat(T[:3, :3])
            t = T[:3, 3]
            f.write(f"{ts:.6f} {t[0]:.6f} {t[1]:.6f} {t[2]:.6f} "
                    f"{q[1]:.6f} {q[2]:.6f} {q[3]:.6f} {q[0]:.6f}\n")


def estimate_point_ts(points: np.ndarray,
                      lidar_type: str = "velodyne") -> Optional[np.ndarray]:
    """Per-point normalized [0,1] timestamps for deskewing when the file
    carries none (reference get_point_ts: dataset/slam_dataset.py:297-347).
    Ouster-style row patterns for known point counts, otherwise a yaw-angle
    heuristic for spinning LiDARs."""
    n = points.shape[0]
    for h, w in ((64, 1024), (128, 1024), (64, 2048), (128, 2048),
                 (32, 1024), (32, 2048)):
        if n == h * w:
            return np.tile(np.linspace(0.0, 1.0, w, endpoint=False),
                           (h, 1)).T.reshape(-1)
    yaw = -np.arctan2(points[:, 1], points[:, 0])  # clockwise spin
    return 0.5 * (yaw / np.pi + 1.0)


def write_ply_points(path: str, points: np.ndarray,
                     colors: Optional[np.ndarray] = None):
    """Binary little-endian point-cloud PLY writer."""
    n = points.shape[0]
    with open(path, "wb") as f:
        hdr = ["ply", "format binary_little_endian 1.0",
               f"element vertex {n}",
               "property float x", "property float y", "property float z"]
        if colors is not None:
            hdr += ["property uchar red", "property uchar green",
                    "property uchar blue"]
        hdr += ["end_header", ""]
        f.write("\n".join(hdr).encode("ascii"))
        if colors is None:
            f.write(points.astype("<f4").tobytes())
        else:
            dt = np.dtype([("xyz", "<f4", (3,)), ("rgb", "u1", (3,))])
            arr = np.empty(n, dt)
            arr["xyz"] = points.astype(np.float32)
            arr["rgb"] = np.clip(colors * 255, 0, 255).astype(np.uint8)
            f.write(arr.tobytes())
