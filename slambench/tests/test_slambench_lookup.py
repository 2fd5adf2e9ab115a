"""A configuration, a traffic mix and a metric added as new files are
found by name: a later benchmark change adds files and edits none."""

import json
import shutil
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import harness as H  # noqa: E402
from slambench.tests import small  # noqa: E402


def test_new_files_are_found_by_name(tmp_path):
    root, bench = small.make_root(tmp_path)
    # a new configuration, mix and per-layer metric, each its own file
    spec = json.loads((root / "configs" / "kitti_cells.json").read_text())
    spec["name"] = "kitti_cells_b"
    (root / "configs" / "kitti_cells_b.json").write_text(json.dumps(spec))
    mix = json.loads((root / "traffic" / "drive.json").read_text())
    mix["route"]["straights_m"] = [120, 90]
    (root / "traffic" / "drive_b.json").write_text(json.dumps(mix))
    (root / "metrics" / "frame.count.py").write_text(
        "def read(run):\n    return float(len(run.frames)) if run.frames "
        "else None\n")
    bench = dict(bench)
    bench["workloads"] = bench["workloads"] + [
        {"name": "kitti_cells_b.drive_b", "config": "kitti_cells_b",
         "traffic": "drive_b", "chips": 1, "why": "a cell added by files"}]
    bench["per_layer"] = bench["per_layer"] + [
        {"name": "frame.count", "unit": "frames", "better": "higher",
         "source": "host_clock", "layer": "frame loop",
         "moves": "frames_per_s", "workloads": ["kitti_cells_b.drive_b"]}]
    assert H.load_json("configs", "kitti_cells_b", root)["name"] == \
        "kitti_cells_b"
    cell = H.cell_of(bench, "kitti_cells_b.drive_b")
    r = H.run_cell(bench, cell, 4, 3, True, "cpu", time.perf_counter(),
                   log=lambda *a: None, root=root)
    assert r["metrics"]["frame.count"]["value"] == r["attempted"] > 0
    assert set(r["checks"]) == set(H.limits(root))


def test_a_missing_name_is_an_error(tmp_path):
    root, _ = small.make_root(tmp_path)
    shutil.rmtree(root / "metrics")
    try:
        H.load_metric("frames_per_s", root)
    except FileNotFoundError as e:
        assert "frames_per_s" in str(e)
    else:
        raise AssertionError("a missing reader was not reported")
