"""The reader of the captured training route's replay share
(`metrics/mapper.replay_share.py`) on hand-made runs."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import harness as H  # noqa: E402


def _run(records, fids=range(10, 14)):
    run = H.Run("frames")
    run.frames = [{"fid": f} for f in fids]
    run.program = list(records)
    return run


def _rec(name, frame):
    from pin_slam_tpu_torch.utils.tracing import SpanRecord
    return SpanRecord(name, 0, 1, 0, -1, frame)


def test_replayed_iterations_over_the_window_iterations():
    rec = []
    for f in range(10, 14):             # 12 iterations a frame, 11 replayed
        rec += [_rec("mapper.iter", f) for _ in range(12)]
        rec += [_rec("mapper.replay", f) for _ in range(11)]
    # the warm-up's frames are not the window's
    rec += [_rec("mapper.iter", 0) for _ in range(480)]
    rec += [_rec("mapper.capture", 0), _rec("mapper.replay", 0)]
    reader = H.load_metric("mapper.replay_share")
    assert reader.read(_run(rec)) == pytest.approx(100.0 * 11 / 12)
    # every iteration eager (the routes without a graph): 0 %
    eager = [r for r in rec if r.name == "mapper.iter"]
    assert reader.read(_run(eager)) == 0.0


def test_nothing_to_read_gives_nothing():
    reader = H.load_metric("mapper.replay_share")
    assert reader.read(H.Run("frames")) is None
    assert reader.read(_run([])) is None
    assert reader.read(_run([_rec("frame", 10)])) is None
