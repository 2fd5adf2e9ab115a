"""A cut-down copy of the benchmark for the CPU tests: the real
configurations and mixes with the map's capacities, the training batch and
the frame counts shrunk (the sensors stay as they are: sparser scans lose
track) so that a run takes under a minute on the CPU, where every kernel
of the program runs its plain PyTorch version. Written into a directory of
its own, which the harness searches by name as it does the real files."""

from __future__ import annotations

import copy
import json
import shutil
from pathlib import Path

from slambench import harness as H

SMALL_TPU = {"map_capacity": 1 << 17, "hash_table_size": 1 << 19,
             "frame_point_cap": 1 << 15, "source_point_cap": 1 << 12,
             "max_frames": 64, "local_set_cap": 1 << 17}


def small_spec(name: str) -> dict:
    spec = H.load_json("configs", name)
    s = copy.deepcopy(spec)
    y = s["yaml"]
    y["tpu"].update(SMALL_TPU)
    y["continual"]["pool_capacity"] = 1000000
    y.setdefault("optimizer", {})["batch_size"] = 2048
    y["optimizer"]["init_iter_ratio"] = 40
    y["optimizer"]["train_subset_hist"] = 4096
    return s


def make_root(tmp: Path) -> tuple:
    """A benchmark root under `tmp` and its BENCHMARK dict."""
    root = tmp / "bench"
    (root / "configs").mkdir(parents=True)
    (root / "traffic").mkdir()
    shutil.copytree(H.ROOT / "metrics", root / "metrics")
    (root / "reference").mkdir()
    shutil.copy(H.ROOT / "reference" / "limits.json", root / "reference")
    (root / "configs" / "kitti_cells.json").write_text(
        json.dumps(small_spec("kitti_cells")))
    t = H.load_json("traffic", "drive")
    t["warmup_frames"] = 3
    t["frames_per_s_cap"] = 1
    (root / "traffic" / "drive.json").write_text(json.dumps(t))
    return root, H.load_bench()


def run_small(tmp: Path, workload: str, seed: int = 3, seconds: float = 4,
              trace: bool = False, control: bool = False):
    import time
    root, bench = make_root(tmp)
    cell = H.cell_of(bench, workload)
    return H.run_cell(bench, cell, seed, seconds, trace, "cpu",
                      time.perf_counter(), log=lambda *a: None, root=root,
                      control=control)
