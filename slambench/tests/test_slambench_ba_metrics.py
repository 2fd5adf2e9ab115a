"""The readers of bundle adjustment's frames and spans and of the
adaptive training schedule (`metrics/ba.frame_ms.py`,
`metrics/ba.host_ms.py`, `metrics/mapper.train_iters.py`, `ba_spans.py`)
on hand-made runs, and the Newer College configuration as the program
reads it."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import harness as H  # noqa: E402


def _run(walls, iters, first=10):
    run = H.Run("frames")
    run.frames = [{"fid": first + i, "wall_s": w, "gn_iters": 4,
                   "pull_s": 0.0, "ba": (first + i + 1) % 20 == 0,
                   "lost": False, "train_iters": it, "src_n": 1000}
                  for i, (w, it) in enumerate(zip(walls, iters))]
    return run


def _rec(name, frame, ms, rid=0, parent=-1):
    from pin_slam_tpu_torch.utils.tracing import SpanRecord
    return SpanRecord(name, 0, int(ms * 1e6), rid, parent, frame)


def test_ba_frame_ms_is_the_mean_of_the_ba_frames():
    walls = [0.3] * 40
    walls[9] = 1.5      # frame 19
    walls[29] = 1.1     # frame 39
    run = _run(walls, [15] * 40)
    assert H.load_metric("ba.frame_ms").read(run) == pytest.approx(1300.0)
    # a window without a BA frame
    assert H.load_metric("ba.frame_ms").read(_run([0.3] * 5, [15] * 5)) \
        is None


def test_train_iters_is_the_mean_over_every_window_frame():
    run = _run([0.3] * 4, [10, 20, 15, 0])
    assert H.load_metric("mapper.train_iters").read(run) == 11.25
    assert H.load_metric("mapper.train_iters").read(H.Run("frames")) is None


def test_ba_host_ms_reads_the_untraced_ba_runs():
    run = _run([0.3] * 60, [15] * 60)       # frames 10..69
    # frame 19 lies in the profiled stretch (frames 15..34), 39 and 59 not
    run.program = [_rec("ba.run", 19, 900.0), _rec("ba.run", 39, 700.0),
                   _rec("ba.run", 59, 500.0), _rec("ba.iter", 39, 8.0),
                   _rec("frame", 40, 300.0)]
    assert H.load_metric("ba.host_ms").read(run) == pytest.approx(600.0)
    run.program = [_rec("frame", 40, 300.0)]
    assert H.load_metric("ba.host_ms").read(run) is None
    assert H.load_metric("ba.host_ms").read(_run([0.3], [15])) is None


def test_ba_split_counts_runs_and_iterations():
    from slambench.ba_spans import ba_split
    run = _run([0.3] * 60, [15] * 60)
    run.program = [_rec("ba.run", 39, 700.0), _rec("ba.run", 59, 500.0)]
    run.program += [_rec("ba.iter", f, 7.0) for f in (39, 59) for _ in
                    range(80)]
    run.program += [_rec("ba.iter", 19, 9.0)]       # traced: left out
    out = ba_split(run)
    assert out["runs"] == 2 and out["iters_per_run"] == 80
    assert out["ms_per_run"]["ba.run"] == pytest.approx(600.0)
    assert out["ms_per_run"]["ba.iter"] == pytest.approx(560.0)
    run.program = []
    assert ba_split(run) == {}


def test_ncd_cells_loads_with_no_departure():
    from slambench.reference import settings as RS
    spec = H.load_json("configs", "ncd_cells")
    cfg = H.make_config(spec, 1842609006)
    st = RS.read(spec["yaml"])
    assert H.config_departures(cfg, st) == []
    assert not st.weighted_first and st.voxel_m == 0.15
    assert st.search_alpha == 0.5 and st.nn_k == 6 and st.bs == 16384
    assert cfg.ba_freq_frame == 20 and cfg.ba_frame == 50
    assert cfg.ba_iters == 80 and cfg.ba_bs == 16384
    assert cfg.adaptive_iters and cfg.adaptive_range_on
    assert cfg.probe_mode == "cells" and not cfg.deskew
    assert set(spec["reduced"]) == {"pc_path", "pose_path", "deskew", "tpu"}
    assert set(spec["reduced"]) == set(spec["reduced_why"])
    assert all(k.startswith("sensor.") and k[7:] in spec["sensor"]
               for k in spec["assumed"])


def test_ncd_cells_is_the_shipped_yaml_with_its_two_reductions():
    import yaml
    spec = H.load_json("configs", "ncd_cells")
    shipped = yaml.safe_load((H.ROOT.parent / spec["yaml_file"]).read_text())
    shipped["setting"]["deskew"] = False
    shipped["tpu"]["probe_mode"] = "cells"
    assert spec["yaml"] == shipped


def test_the_ba_reference_loads_nothing_of_the_program():
    import subprocess
    r = subprocess.run(
        [sys.executable, "-c",
         "import sys\nimport slambench.reference.ba\n"
         "print(sorted({n.split('.')[0] for n in sys.modules} & "
         "{'pin_slam_tpu_torch', 'pin_slam_tpu', 'jax', 'jaxlib'}))\n"],
        cwd=H.ROOT.parent, capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"
