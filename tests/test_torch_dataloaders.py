"""The port's data loaders and in-repo readers (pin_slam_tpu_torch.dataset:
dataloaders/*, rosbag1, mcap1, converter/to_pin_format) against the JAX
package's, on the same small files on disk. Both are the same numpy code,
so every comparison is exact: points, point_ts, has_color, gt_poses,
timestamps and lengths bit for bit.

The files come from the writers tests/test_dataloaders.py uses (kitti_raw,
kitti360, kitti_mot, nuscenes, apollo, paris_luco, ouster, rosbag, mcap) and
from small writers of this file (mulran, ncd, nclt, boreas, helipr,
replica, tum / neuralrgbd, camera images). ROS1 bags and MCAP files go both
ways: written by either package, read by both. The RGB-D cases need PIL.
"""

import struct
import sys
from pathlib import Path

import numpy as np
import pytest

import test_dataloaders as jdl  # the JAX package's fixture writers
from pin_slam_tpu.dataset import mcap1 as jmcap
from pin_slam_tpu.dataset import rosbag1 as jbag
from pin_slam_tpu.dataset.converter import to_pin_format as jconv
from pin_slam_tpu.dataset.dataloaders import dataset_factory as j_factory
from pin_slam_tpu_torch.dataset import mcap1 as tmcap
from pin_slam_tpu_torch.dataset import rosbag1 as tbag
from pin_slam_tpu_torch.dataset.converter import to_pin_format as tconv
from pin_slam_tpu_torch.dataset.dataloaders import dataset_factory as t_factory
import chip_smoke  # the ouster_ros package's cloud layout


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_loaders(t, j):
    """Every frame, the ground truth and the frame timestamps."""
    assert type(t).__name__ == type(j).__name__
    assert type(t).__module__.startswith("pin_slam_tpu_torch.")
    assert len(t) == len(j) > 0
    _same(getattr(t, "gt_poses", None), getattr(j, "gt_poses", None))
    for i in range(len(t)):
        a, b = t[i], j[i]
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    if hasattr(j, "get_frames_timestamps"):
        _same(t.get_frames_timestamps(), j.get_frames_timestamps())


# ------------------------------------------------------------ file writers


def _png(path, arr):
    from PIL import Image
    Image.fromarray(arr).save(str(path))


def _images(d, n, name, shape):
    """n colour gradients of a camera's size."""
    d.mkdir(parents=True, exist_ok=True)
    yx = np.indices(shape)
    for i in range(n):
        _png(d / name.format(i), np.stack(
            [yx[0] + i, yx[1], yx[0] + yx[1]], -1).astype(np.uint8))


def _in_view(scan_dir, n_frames, to_lidar):
    """Scans (xyz + intensity, float32) of points in front of a camera,
    moved into the LiDAR frame by `to_lidar` (a [3, 3] axis change)."""
    r = np.random.RandomState(9)
    for i, f in enumerate(sorted(scan_dir.glob("*.bin"))[:n_frames]):
        z = r.uniform(5.0, 20.0, 600)
        cam = np.stack([r.uniform(-1, 1, 600) * z,
                        r.uniform(-0.4, 0.2, 600) * z, z], -1)
        np.hstack([cam @ to_lidar.T, r.rand(600, 1)]).astype(
            np.float32).tofile(str(f))


def _kitti360(tmp_path, load_img=False):
    jdl.TestKitti360().test_load(tmp_path)
    if load_img:
        pytest.importorskip("PIL")
        _in_view(tmp_path / "data_3d_raw" / "2013_05_28_drive_0000_sync"
                 / "velodyne_points" / "data", 3, np.eye(3))
        _images(tmp_path / "data_2d_raw" / "2013_05_28_drive_0000_sync"
                / "image_00" / "data_rect", 3, "{:010d}.png", (376, 1408))
        return tmp_path, ("0",), dict(load_img=True)
    return tmp_path, ("0",), {}


def _kitti_mot(tmp_path, load_img=False):
    jdl.TestKittiMot().test_load(tmp_path)
    if load_img:
        pytest.importorskip("PIL")
        _in_view(tmp_path / "data_tracking_velodyne" / "training"
                 / "velodyne" / "0003", 2,
                 np.array([[0.0, 0, 1], [-1, 0, 0], [0, -1, 0]]))
        _images(tmp_path / "data_tracking_image_2" / "training" / "image_02"
                / "0003", 2, "{:06d}.png", (375, 1242))
        return tmp_path, ("3",), dict(load_img=True)
    return tmp_path, ("3",), {}


def _nuscenes(tmp_path):
    jdl.TestNuScenes().test_load(tmp_path)
    return tmp_path, ("0",), {}


def _ouster(tmp_path, profile="LEGACY", **pcap):
    o = jdl.TestOuster()
    frames = [o._ranges(0), o._ranges(1)]
    path = str(tmp_path / ("rec.pcapng" if pcap.get("pcapng") else
                           "rec.pcap"))
    jdl._write_pcap(path, o._encode_frames(frames, profile), **pcap)
    o._metadata(tmp_path, profile)
    return path, (), {}


def _jax_bag(tmp_path, compression="none"):
    path = str(tmp_path / "seq.bag")
    jbag.write_bag1(path, jdl.TestRosbag1()._clouds(),
                    compression=compression)
    return path, (), {}


def _jax_mcap(tmp_path, encoding):
    path = str(tmp_path / "seq.mcap")
    jmcap.write_mcap(path, jdl.TestMcap()._clouds(), encoding=encoding)
    return path, (), {}


def _xyzi(n, seed, offset=8.0):
    r = np.random.RandomState(seed)
    pts = r.randn(n, 3) * 5 + [offset, 0, 0]
    return np.hstack([pts, r.rand(n, 1)]).astype(np.float32)


def _rot_rows(n, seed):
    """n row-major 3x4 [R | t] with a yaw and a translation each."""
    r = np.random.RandomState(seed)
    out = []
    for k in range(n):
        a = 0.1 * k + r.rand()
        T = np.eye(4)
        T[:3, :3] = [[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0],
                     [0, 0, 1]]
        T[:3, 3] = r.randn(3)
        out.append(T[:3].reshape(-1))
    return np.stack(out)


def _mulran(tmp_path):
    d = tmp_path / "Ouster"
    d.mkdir()
    stamps = [1000, 1100, 1200]
    for k, s in enumerate(stamps):
        # two full 64 x 1024 scans (per-point times) and a cropped one
        _xyzi(64 * 1024 if k < 2 else 500, k).tofile(str(d / f"{s}.bin"))
    rows = _rot_rows(4, 1)
    t = np.array([990.0, 1090.0, 1210.0, 1300.0])[:, None]
    np.savetxt(str(tmp_path / "global_pose.csv"), np.hstack([t, rows]),
               delimiter=",")
    return tmp_path, (), {}


def _ncd(tmp_path):
    d = tmp_path / "bin"
    d.mkdir()
    for k in range(3):
        _xyzi(64 * 1024 if k != 1 else 700, k).tofile(str(d / f"{k:06d}.bin"))
    r = np.random.RandomState(2)
    q = r.randn(3, 4)
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    rows = np.hstack([np.arange(3)[:, None], np.zeros((3, 1)),
                      r.randn(3, 3), q])
    with open(tmp_path / "gt.csv", "w") as f:
        f.write("sec,nsec,x,y,z,qx,qy,qz,qw\n")
        np.savetxt(f, rows, delimiter=",")
    return tmp_path, (), {}


def _nclt(tmp_path):
    d = tmp_path / "velodyne_sync"
    d.mkdir()
    r = np.random.RandomState(3)
    for k in range(2):
        r.randint(0, 40000, (300, 4)).astype(np.int16).tofile(
            str(d / f"{k:06d}.bin"))
    return tmp_path, (), {}


def _boreas(tmp_path):
    d = tmp_path / "lidar"
    d.mkdir()
    r = np.random.RandomState(4)
    for k in range(2):
        a = r.randn(300, 6).astype(np.float32)
        a[:, 5] = 10.0 + np.sort(r.rand(300)) * 0.1
        a.tofile(str(d / f"{k:06d}.bin"))
    return tmp_path, (), {}


def _helipr(tmp_path, sensor="Ouster"):
    d = tmp_path / "LiDAR" / sensor
    d.mkdir(parents=True)
    r = np.random.RandomState(5)
    fmt = {"Ouster": "ffffIHHH", "Velodyne": "ffffHf"}[sensor]
    for k in range(2):
        recs = [struct.pack(fmt, *r.randn(4), *[int(v) for v in
                                                r.randint(0, 60000, 4)])
                if sensor == "Ouster" else
                struct.pack(fmt, *r.randn(4), int(r.randint(0, 128)),
                            r.rand()) for _ in range(120)]
        (d / f"{k:06d}.bin").write_bytes(b"".join(recs))
    return tmp_path, (sensor,), {}


def _depth_frames(d, n, scale, name_rgb, name_depth):
    r = np.random.RandomState(6)
    for i in range(n):
        depth = (r.rand(24, 32) * 5.0 + 0.5) * scale
        depth[r.rand(24, 32) < 0.1] = 0
        _png(d / name_depth.format(i), depth.astype(np.uint16))
        _png(d / name_rgb.format(i),
             r.randint(0, 256, (24, 32, 3)).astype(np.uint8))


def _replica(tmp_path):
    pytest.importorskip("PIL")
    res = tmp_path / "room0" / "results"
    res.mkdir(parents=True)
    _depth_frames(res, 3, 6553.5, "frame{:06d}.jpg", "depth{:06d}.png")
    rows = np.stack([np.eye(4).reshape(-1) + 0.01 * k for k in range(3)])
    np.savetxt(str(tmp_path / "room0" / "traj.txt"), rows)
    return tmp_path, ("room0",), dict(down_rate=2)


def _tum(tmp_path):
    pytest.importorskip("PIL")
    seq = tmp_path / "fr1"
    (seq / "rgb").mkdir(parents=True)
    (seq / "depth").mkdir()
    _depth_frames(seq, 3, 5000.0, "rgb/{:d}.png", "depth/{:d}.png")
    t = [10.0, 10.033, 10.066]
    for name, off in (("rgb", 0.0), ("depth", 0.01)):
        with open(seq / f"{name}.txt", "w") as f:
            f.write(f"# {name}\n")
            for i, ti in enumerate(t):
                f.write(f"{ti + off:.6f} {name}/{i}.png\n")
    r = np.random.RandomState(8)
    with open(seq / "groundtruth.txt", "w") as f:
        f.write("# timestamp tx ty tz qx qy qz qw\n")
        for k in range(6):
            f.write(" ".join(f"{v:.6f}" for v in
                             [9.99 + 0.02 * k, *r.randn(7)]) + "\n")
    return tmp_path, ("fr1",), {}


CASES = {
    "kitti_raw": ("kitti_raw",
                  lambda p: (jdl.TestKittiRaw()._fixture(p), ("04",), {})),
    "kitti360": ("kitti360", _kitti360),
    "kitti360_img": ("kitti360", lambda p: _kitti360(p, load_img=True)),
    "kitti_mot": ("kitti_mot", _kitti_mot),
    "kitti_mot_img": ("kitti_mot", lambda p: _kitti_mot(p, load_img=True)),
    "nuscenes": ("nuscenes", _nuscenes),
    "apollo": ("apollo", lambda p: (jdl.TestApollo()._fixture(p), (), {})),
    "paris_luco": ("paris_luco",
                   lambda p: (jdl.TestParisLuco()._fixture(p), (), {})),
    "ouster_legacy": ("ouster", _ouster),
    "ouster_rng19": ("ouster", lambda p: _ouster(p, "RNG19")),
    "ouster_fragmented": ("ouster",
                          lambda p: _ouster(p, fragment_mtu=1400)),
    "ouster_pcapng": ("ouster", lambda p: _ouster(p, pcapng=True)),
    "rosbag": ("rosbag", _jax_bag),
    "rosbag_bz2": ("rosbag", lambda p: _jax_bag(p, "bz2")),
    "mcap_cdr": ("mcap", lambda p: _jax_mcap(p, "cdr")),
    "mcap_ros1": ("mcap", lambda p: _jax_mcap(p, "ros1")),
    "mulran": ("mulran", _mulran),
    "ncd": ("ncd", _ncd),
    "nclt": ("nclt", _nclt),
    "boreas": ("boreas", _boreas),
    "helipr_ouster": ("helipr", _helipr),
    "helipr_velodyne": ("helipr", lambda p: _helipr(p, "Velodyne")),
    "replica": ("replica", _replica),
    "tum": ("tum", _tum),
    "neuralrgbd": ("neuralrgbd", _tum),
}

# one file set for each loader name (tests/test_torch_dataset.py's factory
# test builds its data from these)
BUILDERS = {name: build for name, build in CASES.values()}


@pytest.mark.parametrize("case", sorted(CASES))
def test_loader_reads_what_the_jax_loader_reads(case, tmp_path):
    name, build = CASES[case]
    path, args, kw = build(tmp_path)
    _same_loaders(t_factory(name, path, *args, **kw),
                  j_factory(name, path, *args, **kw))


def test_kitti_raw_velocities(tmp_path):
    root = jdl.TestKittiRaw()._fixture(tmp_path)
    t, j = t_factory("kitti_raw", root, "04"), j_factory("kitti_raw", root,
                                                         "04")
    _same(t.oxts, j.oxts)
    for i in range(len(t)):
        for a, b in zip(t.get_velocities(i), j.get_velocities(i)):
            _same(a, b)


# ------------------------------------------------- ROS1 bags, both ways


def _expected(cloud):
    """What read_point_cloud2 gives for a written cloud: float32 points as
    float64, the time field normalised to [0, 1]."""
    if hasattr(cloud, "fields"):
        from pin_slam_tpu_torch.utils import point_cloud2 as pc2
        arr = np.frombuffer(cloud.data, pc2.fields_to_dtype(
            cloud.fields, cloud.point_step), cloud.width * cloud.height)
        pts = np.stack([arr["x"], arr["y"], arr["z"]], -1)
        ts = arr["t"]
    else:
        pts, ts = cloud
    ts = np.asarray(ts, np.float64)
    return (np.asarray(pts, np.float32).astype(np.float64),
            (ts - ts.min()) / (ts.max() - ts.min()))


def _reads_back(loader, clouds, times):
    assert len(loader) == len(clouds)
    for k, c in enumerate(clouds):
        d = loader[k]
        pts, ts = _expected(c)
        _same(d["points"], pts)
        _same(d["point_ts"], ts)
    assert loader.get_frames_timestamps() == times


def _ouster_clouds(n, h=8, w=32, seed=0):
    """Organised Ouster-layout clouds with some rays without a return."""
    r = np.random.RandomState(seed)
    out = []
    for _ in range(n):
        xyz = (r.randn(h, w, 3) * 6).astype(np.float32)
        xyz[r.rand(h, w) < 0.2] = 0.0
        out.append(chip_smoke.ouster_cloud(
            xyz, np.arange(w, dtype=np.uint32) * 97_656))
    return out


@pytest.mark.parametrize("compression", ["none", "bz2"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_bag_written_by_either_package(writer, compression, tmp_path):
    clouds = jdl.TestRosbag1()._clouds()
    path = str(tmp_path / "seq.bag")
    (jbag if writer == "jax" else tbag).write_bag1(
        path, clouds, topic="/os/points", compression=compression)
    other = str(tmp_path / "other.bag")
    (tbag if writer == "jax" else jbag).write_bag1(
        other, clouds, topic="/os/points", compression=compression)
    assert Path(path).read_bytes() == Path(other).read_bytes()
    for factory in (t_factory, j_factory):
        _reads_back(factory("rosbag", path), clouds, [0.0, 0.1, 0.2, 0.3])
    assert tbag.Bag1Reader(path).topics() == jbag.Bag1Reader(path).topics()


@pytest.mark.parametrize("chunk_msgs", [0, 2])
def test_port_bag_of_ouster_clouds_reads_in_both(chunk_msgs, tmp_path):
    """The ouster_ros package's organised clouds (t in uint32 ns, rays
    without a return at the origin), in one chunk or chunks of two."""
    clouds = _ouster_clouds(5)
    path = str(tmp_path / "os.bag")
    tbag.write_bag1(path, clouds, topic="/os_cloud_node/points",
                    chunk_msgs=chunk_msgs)
    assert len(jbag.Bag1Reader(path).chunks) == (3 if chunk_msgs else 1)
    times = [0.0, 0.1, 0.2, pytest.approx(0.3), 0.4]
    for factory in (t_factory, j_factory):
        _reads_back(factory("rosbag", path), clouds, times)
    msg = tbag.deserialize_pointcloud2(
        next(tbag.Bag1Reader(path).iter_topic("/os_cloud_node/points"))[1])
    assert (msg.height, msg.width, msg.point_step) == (8, 32, 48)
    assert [f.name for f in msg.fields] == [
        n for n, _, _ in chip_smoke.OUSTER_FIELDS]


def test_split_bags_merge_in_time_order(tmp_path):
    """Two bags of one recording whose messages interleave in time: both
    packages replay them as one sequence in timestamp order."""
    clouds = jdl.TestRosbag1()._clouds(6)
    tbag.write_bag1(str(tmp_path / "a.bag"), clouds[0::2], hz=5.0)
    tbag.write_bag1(str(tmp_path / "b.bag"), clouds[1::2], hz=5.0, t0=0.1)
    times = [0.0, 0.1, 0.2, pytest.approx(0.3), 0.4, 0.5]
    for factory in (t_factory, j_factory):
        _reads_back(factory("rosbag", str(tmp_path)), clouds, times)


def test_bag_topic_selection_and_errors(tmp_path):
    clouds = jdl.TestRosbag1()._clouds(2)
    tbag.write_bag1(str(tmp_path / "a.bag"), clouds, topic="/front")
    jbag.write_bag1(str(tmp_path / "b.bag"), clouds, topic="/rear")
    for factory in (t_factory, j_factory):
        with pytest.raises(ValueError, match="multiple PointCloud2 topics"):
            factory("rosbag", str(tmp_path))
        with pytest.raises(ValueError, match="not found"):
            factory("rosbag", str(tmp_path), "/nope")
        with pytest.raises(FileNotFoundError, match="no .bag files"):
            factory("rosbag", str(tmp_path / "a.bag.d"))
    for topic in ("/front", "/rear"):
        _same_loaders(t_factory("rosbag", str(tmp_path), topic),
                      j_factory("rosbag", str(tmp_path), topic))


# ------------------------------------------------------- MCAP, both ways


@pytest.mark.parametrize("encoding", ["cdr", "ros1"])
@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_mcap_written_by_either_package(writer, encoding, tmp_path):
    clouds = jdl.TestMcap()._clouds()
    path = str(tmp_path / "seq.mcap")
    (jmcap if writer == "jax" else tmcap).write_mcap(
        path, clouds, topic="/os/points", encoding=encoding)
    for factory in (t_factory, j_factory):
        _reads_back(factory("mcap", path), clouds, [0.0, 0.1, 0.2])
        with pytest.raises(ValueError, match="not found"):
            factory("mcap", path, "/wrong")
    assert tmcap.McapReader(path).topics() == jmcap.McapReader(path).topics()
    assert tmcap.serialize_pointcloud2_cdr(*clouds[0][:1], 1.5,
                                           point_ts=clouds[0][1]) == \
        jmcap.serialize_pointcloud2_cdr(*clouds[0][:1], 1.5,
                                        point_ts=clouds[0][1])


@pytest.mark.parametrize("encoding", ["cdr", "ros1"])
def test_port_mcap_of_ouster_clouds_reads_in_both(encoding, tmp_path):
    clouds = _ouster_clouds(3, seed=1)
    path = str(tmp_path / "os.mcap")
    tmcap.write_mcap(path, clouds, topic="/os_cloud_node/points",
                     encoding=encoding)
    for factory in (t_factory, j_factory):
        _reads_back(factory("mcap", path), clouds, [0.0, 0.1, 0.2])


# ------------------------------------------------------------ converter


@pytest.mark.parametrize("case", ["kitti_raw", "tum"])
def test_converter_writes_the_same_files(case, tmp_path, monkeypatch):
    """The JAX package's convert() and the port's CLI (its main, as
    `python -m pin_slam_tpu_torch.dataset.converter.to_pin_format` runs
    it) write the same PLY files and poses.txt."""
    name, build = CASES[case]
    path, args, _ = build(tmp_path / "in")
    seq = args[0] if args else None
    jconv.convert(name, str(path), seq, str(tmp_path / "jax"), 2)
    argv = ["to_pin_format", "--loader", name, "--input", str(path),
            "--output", str(tmp_path / "torch"), "--down-rate", "2"]
    if seq is not None:
        argv += ["--sequence", seq]
    monkeypatch.setattr(sys, "argv", argv)
    tconv.main()
    files = sorted(p.relative_to(tmp_path / "jax")
                   for p in (tmp_path / "jax").rglob("*") if p.is_file())
    assert Path("poses.txt") in files and len(files) >= 3
    assert files == sorted(p.relative_to(tmp_path / "torch")
                           for p in (tmp_path / "torch").rglob("*")
                           if p.is_file())
    for f in files:
        assert (tmp_path / "jax" / f).read_bytes() == \
            (tmp_path / "torch" / f).read_bytes(), f
