"""The port's host dataset layer (pin_slam_tpu_torch.dataset: io,
slam_dataset, dataset_indexing, dataloaders) against the JAX package's, on
one small dataset on disk: the same files read to the same arrays (exactly:
both are the same numpy code), the same poses and calibration, the same
deskewed, corrected and cropped clouds, the same result files and metrics,
the same dataset shortcuts and the same loaders. TUM quaternions are written
with six decimals from float32 in both packages: they agree to 1e-6."""

import numpy as np
import pytest

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu.dataset import dataset_indexing as jdi
from pin_slam_tpu.dataset import io as jio
from pin_slam_tpu.dataset import slam_dataset as jsd
from pin_slam_tpu.dataset.dataloaders import dataset_factory as j_factory
from pin_slam_tpu_torch.config import Config as TConfig
from pin_slam_tpu_torch.dataset import dataset_indexing as tdi
from pin_slam_tpu_torch.dataset import io as tio
from pin_slam_tpu_torch.dataset import slam_dataset as tsd
from pin_slam_tpu_torch.dataset.dataloaders import available_dataloaders
from pin_slam_tpu_torch.dataset.dataloaders import dataset_factory as t_factory
from pin_slam_tpu_torch.dataset.synthetic import (
    SyntheticSequence, circle_trajectory, default_scene, lidar_directions)

N = 4
TUM_ATOL = 1e-6


def write_ply_with_time(path, pts, ts, colors=None):
    """Binary PLY with x, y, z, (red, green, blue,) time."""
    fields = [("x", "<f4"), ("y", "<f4"), ("z", "<f4")]
    if colors is not None:
        fields += [("red", "u1"), ("green", "u1"), ("blue", "u1")]
    fields.append(("time", "<f8"))
    arr = np.empty(len(pts), np.dtype(fields))
    arr["x"], arr["y"], arr["z"] = pts[:, 0], pts[:, 1], pts[:, 2]
    if colors is not None:
        for i, c in enumerate(("red", "green", "blue")):
            arr[c] = colors[:, i]
    arr["time"] = ts
    types = {"<f4": "float", "u1": "uchar", "<f8": "double"}
    hdr = ["ply", "format binary_little_endian 1.0",
           f"element vertex {len(pts)}"]
    hdr += [f"property {types[t]} {n}" for n, t in fields]
    hdr += ["end_header", ""]
    with open(path, "wb") as f:
        f.write("\n".join(hdr).encode("ascii"))
        f.write(arr.tobytes())


@pytest.fixture(scope="module")
def disk(tmp_path_factory):
    """A swept synthetic sequence on disk: PLY scans with a time field and
    colours, KITTI poses in the camera frame with a calib.txt, TUM poses,
    SemanticKITTI labels, a KITTI odometry tree (.bin scans, calib with P2,
    images) and one scan in each other format."""
    from PIL import Image

    root = tmp_path_factory.mktemp("dataset")
    seq = SyntheticSequence(
        scene_sdf=default_scene(),
        poses=circle_trajectory(N, radius=6.0, revolutions=0.05,
                                ease_in_frames=2),
        dirs=lidar_directions(128, 8), max_range=60.0, sweep=True)
    rng = np.random.RandomState(0)
    Tr = np.eye(4)
    Tr[:3, :3] = np.array([[0, -1, 0], [0, 0, -1], [1, 0, 0]], float)
    Tr[:3, 3] = [0.1, -0.2, 0.3]
    (root / "ply").mkdir()
    (root / "labels").mkdir()
    kitti = root / "kitti"
    vel = kitti / "sequences" / "00" / "velodyne"
    img = kitti / "sequences" / "00" / "image_2"
    vel.mkdir(parents=True)
    img.mkdir(parents=True)
    (kitti / "poses").mkdir()
    frames = []
    for i in range(N):
        pts, ts = seq.frame_with_ts(i)
        cols = rng.randint(0, 256, (len(pts), 3)).astype(np.uint8)
        write_ply_with_time(str(root / "ply" / f"{i:06d}.ply"), pts, ts,
                            cols)
        raw = rng.choice([10, 30, 40, 252, 50], len(pts)).astype(np.uint32)
        raw.tofile(str(root / "labels" / f"{i:06d}.label"))
        np.hstack([pts, rng.rand(len(pts), 1).astype(np.float32)]).astype(
            np.float32).tofile(str(vel / f"{i:06d}.bin"))
        Image.fromarray(rng.randint(0, 256, (40, 120, 3)).astype(
            np.uint8)).save(str(img / f"{i:06d}.png"))
        frames.append((pts, ts))
    cam = np.stack([Tr @ T @ np.linalg.inv(Tr) for T in seq.poses])
    jio.write_kitti_format_poses(str(root / "poses.txt"), cam)
    jio.write_kitti_format_poses(str(kitti / "poses" / "00.txt"), cam)
    calib = ("P2: 60 0 60 0 0 60 20 0 0 0 1 0\n"
             "Tr: " + " ".join(f"{v:.9f}" for v in Tr[:3].reshape(-1))
             + "\n")
    (root / "calib.txt").write_text(calib)
    (kitti / "sequences" / "00" / "calib.txt").write_text(calib)
    jio.write_tum_format_poses(str(root / "poses_tum.txt"), seq.poses)
    other = root / "other"
    other.mkdir()
    pts = frames[0][0]
    np.save(str(other / "a.npy"), pts.astype(np.float64))
    with open(other / "b.pcd", "w") as f:
        f.write("VERSION .7\nFIELDS x y z\nSIZE 4 4 4\nTYPE F F F\n"
                f"COUNT 1 1 1\nWIDTH {len(pts)}\nHEIGHT 1\n"
                f"POINTS {len(pts)}\nDATA ascii\n")
        np.savetxt(f, pts, fmt="%.6f")
    arr = np.zeros(len(pts), np.dtype([("x", "<f4"), ("y", "<f4"),
                                       ("z", "<f4"), ("i", "<f4")]))
    arr["x"], arr["y"], arr["z"] = pts.T
    with open(other / "c.pcd", "wb") as f:
        f.write(("VERSION .7\nFIELDS x y z intensity\nSIZE 4 4 4 4\n"
                 "TYPE F F F F\nCOUNT 1 1 1 1\n"
                 f"WIDTH {len(pts)}\nHEIGHT 1\nPOINTS {len(pts)}\n"
                 "DATA binary\n").encode())
        f.write(arr.tobytes())
    jio.write_ply_points(str(other / "d.ply"), pts)
    return root, seq, Tr


def _cfg(cls, root, **kw):
    c = cls()
    c.pc_path = str(root / "ply")
    c.pose_path = str(root / "poses.txt")
    c.calib_path = str(root / "calib.txt")
    c.silence = True
    for k, v in kw.items():
        setattr(c, k, v)
    return c.finalize()


def _same(a, b):
    if a is None or b is None:
        assert a is None and b is None
        return
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["ply/000001.ply", "kitti/sequences/00/"
                                  "velodyne/000002.bin", "other/a.npy",
                                  "other/b.pcd", "other/c.pcd",
                                  "other/d.ply"])
@pytest.mark.parametrize("color_channel", [0, 1, 3])
def test_read_point_cloud(disk, name, color_channel):
    path = str(disk[0] / name)
    tp, tts = tio.read_point_cloud(path, color_channel)
    jp, jts = jio.read_point_cloud(path, color_channel)
    _same(tp, jp)
    _same(tts, jts)


def test_poses_calib_and_writers(disk, tmp_path):
    root, seq, Tr = disk
    tc = tio.read_kitti_format_calib(str(root / "calib.txt"))
    jc = jio.read_kitti_format_calib(str(root / "calib.txt"))
    assert sorted(tc) == sorted(jc)
    for k in tc:
        _same(tc[k], jc[k])
    tp = tio.read_kitti_format_poses(str(root / "poses.txt"))
    _same(np.stack(tp), np.stack(jio.read_kitti_format_poses(
        str(root / "poses.txt"))))
    _same(np.stack(tio.apply_kitti_format_calib(tp, tc["Tr"])),
          np.stack(jio.apply_kitti_format_calib(tp, tc["Tr"])))
    for mod in (tio, jio):     # SLAMDataset then falls back to TUM
        with pytest.raises(ValueError):
            mod.read_kitti_format_poses(str(root / "poses_tum.txt"))
    t_tum, t_ts = tio.read_tum_format_poses(str(root / "poses_tum.txt"))
    j_tum, j_ts = jio.read_tum_format_poses(str(root / "poses_tum.txt"))
    _same(np.stack(t_tum), np.stack(j_tum))
    assert t_ts == j_ts
    tio.write_kitti_format_poses(str(tmp_path / "k.txt"), seq.poses)
    jio.write_kitti_format_poses(str(tmp_path / "kj.txt"), seq.poses)
    assert (tmp_path / "k.txt").read_text() == \
        (tmp_path / "kj.txt").read_text()
    tio.write_tum_format_poses(str(tmp_path / "t.txt"), seq.poses)
    a = np.loadtxt(str(tmp_path / "t.txt"))
    b = np.loadtxt(str(root / "poses_tum.txt"))
    np.testing.assert_allclose(a, b, atol=TUM_ATOL, rtol=0)
    pts = seq.frame(0)
    tio.write_ply_points(str(tmp_path / "p.ply"), pts,
                         np.random.RandomState(1).rand(len(pts), 3))
    jio.write_ply_points(str(tmp_path / "pj.ply"), pts,
                         np.random.RandomState(1).rand(len(pts), 3))
    assert (tmp_path / "p.ply").read_bytes() == \
        (tmp_path / "pj.ply").read_bytes()


@pytest.mark.parametrize("shape", [(0, 0), (64, 1024), (32, 2048)])
@pytest.mark.parametrize("lidar", ["velodyne", "ouster"])
def test_estimate_point_ts(shape, lidar):
    """The row pattern of known Ouster sizes and the yaw heuristic."""
    n = shape[0] * shape[1] or 5000
    pts = np.random.RandomState(2).randn(n, 3) * 10
    _same(tio.estimate_point_ts(pts, lidar), jio.estimate_point_ts(pts, lidar))


@pytest.mark.parametrize("deskew", [False, True])
@pytest.mark.parametrize("correct", [0.0, 0.195])
@pytest.mark.parametrize("semantic", [False, True])
def test_slam_dataset_frames(disk, deskew, correct, semantic):
    """SLAMDataset over the PLY folder: gt poses moved into the LiDAR frame,
    frames with their time field (or, without one, estimated timestamps),
    the KITTI correction and the label filter."""
    root = disk[0]
    kw = dict(deskew=deskew, kitti_correction_on=correct > 0,
              correction_deg=correct, begin_frame=1, step_frame=1,
              semantic_on=semantic, label_path=str(root / "labels"),
              color_channel=3)
    td = tsd.SLAMDataset(_cfg(TConfig, root, **kw))
    jd = jsd.SLAMDataset(_cfg(JConfig, root, **kw))
    assert td.total_pc_count == jd.total_pc_count == N - 1
    assert td.gt_pose_provided and jd.gt_pose_provided
    _same(td.gt_poses, jd.gt_poses)
    np.testing.assert_allclose(td.gt_poses, disk[1].poses[1:], atol=1e-6)
    for i in range(td.total_pc_count):
        for a, b in zip(td.read_frame_sem(i), jd.read_frame_sem(i)):
            _same(a, b)


def test_deskew_correct_crop(disk):
    root, seq, _ = disk
    pts, ts = seq.frame_with_ts(2)
    pts = pts.astype(np.float64)
    tran = np.linalg.inv(seq.poses[1]) @ seq.poses[2]
    for mid in (0.0, 0.5):
        _same(tsd.SLAMDataset.deskew(pts, ts, tran, mid),
              jsd.SLAMDataset.deskew(pts, ts, tran, mid))
    _same(tsd.SLAMDataset.deskew(pts, None, tran),
          jsd.SLAMDataset.deskew(pts, None, tran))
    for deg in (0.0, 0.195, -0.195):
        _same(tsd.intrinsic_correct(pts, deg), jsd.intrinsic_correct(pts, deg))
    # the correction keeps the range and adds the angle back
    back = tsd.intrinsic_correct(tsd.intrinsic_correct(pts, -0.195), 0.195)
    np.testing.assert_allclose(back, pts, atol=1e-9)
    _same(tsd.crop_frame_np(pts, -1.0, 3.0, 2.0, 20.0),
          jsd.crop_frame_np(pts, -1.0, 3.0, 2.0, 20.0))


def test_write_results(disk, tmp_path):
    root, seq, _ = disk
    td = tsd.SLAMDataset(_cfg(TConfig, root, silence=True))
    jd = jsd.SLAMDataset(_cfg(JConfig, root, silence=True))
    rng = np.random.RandomState(3)
    odom = td.gt_poses.copy()
    odom[:, :3, 3] += rng.randn(N, 3) * 0.05
    slam = td.gt_poses.copy()
    timings = rng.rand(N, 5)
    tm = td.write_results(str(tmp_path / "t"), odom, slam, timings)
    jm = jd.write_results(str(tmp_path / "j"), odom, slam, timings)
    assert tm == jm and tm["Absoulte Trajectory Error [m]"] > 0
    for f in ("odom_poses_kitti.txt", "slam_poses_kitti.txt",
              "pose_eval.csv"):
        assert (tmp_path / "t" / f).read_text() == \
            (tmp_path / "j" / f).read_text(), f
    for f in ("odom_poses_tum.txt", "slam_poses_tum.txt"):
        np.testing.assert_allclose(np.loadtxt(str(tmp_path / "t" / f)),
                                   np.loadtxt(str(tmp_path / "j" / f)),
                                   atol=TUM_ATOL, rtol=0)
    _same(np.load(str(tmp_path / "t" / "time_table.npy")), timings)


@pytest.mark.parametrize("name", ["kitti", "mulran", "kitti_carla", "ncd",
                                  "ncd128", "ipbcar", "hilti", "m2dgr",
                                  "replica", "synthetic", "unknown"])
@pytest.mark.parametrize("loader", [False, True])
def test_set_dataset_path(name, loader):
    fields = ("name", "pc_path", "pose_path", "calib_path", "label_path",
              "kitti_correction_on", "correction_deg", "data_loader_name",
              "data_loader_seq")
    out = []
    for cls, mod in ((TConfig, tdi), (JConfig, jdi)):
        c = cls()
        c.pc_path = "/data/set/seq/sub/scans"
        c.use_dataloader = loader
        mod.set_dataset_path(c, name, "07")
        out.append({f: getattr(c, f) for f in fields})
    assert out[0] == out[1]


@pytest.mark.parametrize("load_img", [False, True])
def test_kitti_loader(disk, load_img):
    root = disk[0]
    t = t_factory("kitti", str(root / "kitti"), "00", load_img=load_img)
    j = j_factory("kitti", str(root / "kitti"), "00", load_img=load_img)
    assert len(t) == len(j) == N
    _same(t.gt_poses, j.gt_poses)
    for i in (0, N - 1):
        a, b = t[i], j[i]
        assert sorted(a) == sorted(b)
        for k in a:
            _same(a[k], b[k])
    if load_img:
        assert t[0]["points"].shape[1] == 6 and t[0]["has_color"].any()


def test_generic_loader_and_dataset_over_a_loader(disk):
    root = disk[0]
    t = t_factory("generic", str(root / "ply"))
    j = j_factory("generic", str(root / "ply"))
    assert len(t) == len(j) == N
    _same(t.gt_poses, j.gt_poses)
    for a, b in zip(t[1].values(), j[1].values()):
        _same(a, b)
    kw = dict(use_dataloader=True, data_loader_name="kitti",
              data_loader_seq="00", begin_frame=1, end_frame=3,
              pc_path=str(root / "kitti"))
    td = tsd.SLAMDataset(_cfg(TConfig, root, **kw))
    jd = jsd.SLAMDataset(_cfg(JConfig, root, **kw))
    assert td.total_pc_count == jd.total_pc_count == 2
    _same(td.gt_poses, jd.gt_poses)
    for a, b in zip(td.read_frame_sem(1), jd.read_frame_sem(1)):
        _same(a, b)


@pytest.mark.parametrize("name", [n for n in available_dataloaders()
                                  if n != "synthetic"])
def test_factory_serves_every_loader(name, disk, tmp_path):
    """Every loader name of the JAX factory gives the port's own class of
    the same name (files from tests/test_torch_dataloaders.py's writers)."""
    if name in ("generic", "kitti"):
        path, args = (str(disk[0] / "ply"), ()) if name == "generic" else \
            (str(disk[0] / "kitti"), ("00",))
        kw = {}
    else:
        from test_torch_dataloaders import BUILDERS
        path, args, kw = BUILDERS[name](tmp_path)
    t = t_factory(name, path, *args, **kw)
    j = j_factory(name, path, *args, **kw)
    assert type(t).__module__ == type(j).__module__.replace(
        "pin_slam_tpu.", "pin_slam_tpu_torch.", 1)
    assert type(t).__name__ == type(j).__name__ and len(t) == len(j) > 0


def test_unknown_loader_raises():
    with pytest.raises(ValueError, match="unknown dataloader"):
        t_factory("nonsense", "/nowhere")
    with pytest.raises(ValueError, match="unknown dataloader"):
        t_factory("synthetic", "/nowhere")
