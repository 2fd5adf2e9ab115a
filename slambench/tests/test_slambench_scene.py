"""The device ray caster against its NumPy copy, and the frames it makes
against the scene's ground truth."""

import json
import sys
from pathlib import Path

import numpy as np
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import harness as H  # noqa: E402
from slambench.scene import cast, cast_np  # noqa: E402
from slambench.scene.frames import make_frames  # noqa: E402
from slambench.scene.route import build_town  # noqa: E402


def _prims(rng):
    boxes = np.stack([rng.uniform(-20, 20, 12), rng.uniform(-20, 20, 12),
                      np.zeros(12), rng.uniform(1, 15, 12),
                      rng.uniform(1, 8, 12), rng.uniform(1, 5, 12),
                      rng.uniform(-3, 3, 12)], -1)
    cyl = np.stack([rng.uniform(-20, 20, 9), rng.uniform(-20, 20, 9),
                    rng.uniform(0.1, 0.5, 9), np.zeros(9),
                    rng.uniform(1, 3, 9)], -1)
    return boxes, cyl


def test_device_caster_matches_numpy():
    rng = np.random.default_rng(0)
    boxes, cyl = _prims(rng)
    o = np.concatenate([rng.uniform(-30, 30, (500, 2)),
                        rng.uniform(0.5, 4.0, (500, 1))], 1)
    d = rng.normal(size=(500, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    ref = cast_np.cast(o, d, boxes, cyl)
    t = lambda a: torch.as_tensor(a, dtype=torch.float64)  # noqa: E731
    got = cast.cast(t(o), t(d), t(boxes), t(cyl)).numpy()
    assert np.isfinite(ref).sum() > 300
    assert np.array_equal(np.isfinite(got), np.isfinite(ref))
    f = np.isfinite(ref)
    np.testing.assert_allclose(got[f], ref[f], rtol=0, atol=1e-9)


def test_frames_lie_on_the_scene_at_their_truth():
    spec = H.load_json("configs", "kitti_cells")
    spec["sensor"].update(columns=180, rows=16, range_noise_m=0.0)
    traffic = H.load_json("traffic", "drive")
    fr = make_frames(spec, traffic, 5, 3, "cpu")
    boxes, cyl = fr.boxes, fr.cylinders
    for i in range(3):
        T = fr.truth[i]
        p = fr.points[i]
        # back to the scan's own elevations, then cast along each point's
        # direction from the true pose: the depth is the point's range
        dist = np.linalg.norm(p, axis=1)
        v = np.arcsin(p[:, 2] / dist) + np.radians(
            spec["sensor"]["lower_elevation_deg"])
        s = np.cos(v) / np.cos(np.arcsin(p[:, 2] / dist))
        q = np.stack([p[:, 0] * s, p[:, 1] * s, dist * np.sin(v)], 1)
        dirs = (q / dist[:, None]) @ T[:3, :3].T
        depth = cast_np.cast(np.broadcast_to(T[:3, 3], dirs.shape), dirs,
                             boxes, cyl)
        # the scans are cast in float32: a ray that grazes an edge may hit
        # on one side of it and miss on the other
        assert np.mean(np.abs(depth - dist) < 2e-3) > 0.995


def test_a_seed_gives_the_same_scans():
    """The same seed casts the same scans; another draws other noise."""
    spec = H.load_json("configs", "kitti_cells")
    spec["sensor"].update(columns=128, rows=16)
    traffic = H.load_json("traffic", "drive")
    a, b = (make_frames(spec, traffic, 2147483999, 6, "cpu")
            for _ in range(2))
    assert all(np.array_equal(p, q) for p, q in zip(a.points, b.points))
    assert np.array_equal(a.truth, b.truth)
    c = make_frames(spec, traffic, 2147484000, 6, "cpu")
    assert not np.array_equal(a.points[3], c.points[3])


def test_a_seed_starts_the_same_town_elsewhere_in_its_cycle():
    traffic = json.loads((H.ROOT / "traffic" / "drive.json").read_text())
    a = build_town(traffic, 1, 900.0)
    b = build_town(traffic, 2, 900.0)
    ha = np.unique(np.round(a[1][a[1][:, 3] > 4.0][:, 3], 6))
    hb = np.unique(np.round(b[1][b[1][:, 3] > 4.0][:, 3], 6))
    # the façade heights come from one catalogue, passed in full by both
    assert np.intersect1d(ha, hb).size >= 0.9 * max(ha.size, hb.size)
    assert ha.size <= 8
    assert not np.array_equal(a[1][:5], b[1][:5])
