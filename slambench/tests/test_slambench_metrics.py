"""The metric arithmetic on hand-made runs, and the FLOP counts against
hand counts."""

import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import harness as H  # noqa: E402
from slambench import yardstick as Y  # noqa: E402
from slambench.reference import settings as RS  # noqa: E402


def _run(walls, window_s):
    run = H.Run("frames")
    run.frames = [{"fid": i, "wall_s": w, "gn_iters": 4, "pull_s": 0.001,
                   "ba": i == 3, "lost": False, "train_iters": 12,
                   "src_n": 1000} for i, w in enumerate(walls)]
    run.window_s = window_s
    run.settings = RS.read(H.load_json("configs", "kitti_cells")["yaml"])
    run.bs = 16384
    return run


def test_rate_is_over_the_whole_window_with_its_stall():
    walls = [0.1] * 9 + [2.0]
    run = _run(walls, 2.95)
    fps = H.load_metric("frames_per_s").read(run)
    assert fps == pytest.approx(10 / 2.95)


def test_p90_is_over_every_frame():
    walls = [0.1 * (i + 1) for i in range(20)]     # 0.1 .. 2.0 s
    run = _run(walls, sum(walls))
    # nearest rank: the 18th of 20 sorted values
    assert H.load_metric("pose_ms_p90").read(run) == pytest.approx(1800.0)
    assert Y.p90([5.0]) == 5.0


def test_readers_with_nothing_to_read_return_nothing():
    run = _run([0.1, 0.1, 0.1, 0.7, 0.1], 0.5)
    assert H.load_metric("tracker.device_ms").read(run) is None
    assert H.load_metric("device.kernels_per_frame").read(run) is None


def test_decoder_flops_against_a_hand_count():
    # 11 inputs, 64 hidden, 1 output: 2*11*64 + 64 + 2*64*1 + 1
    assert Y.mlp_flops(11, 64, 1) == 1601
    st = RS.read(H.load_json("configs", "kitti_cells")["yaml"])
    assert st.weighted_first and st.nn_k == 6 and st.feature_dim == 8
    # 6 neighbours x (3 offset + 3 square + 2 weight + 2 x 11 weighted
    # sum) + one decoder on the mean
    assert Y.decode_flops(st, 1) == 6 * 30 + 1601
    yaml = dict(H.load_json("configs", "kitti_cells")["yaml"])
    yaml["neuralpoints"] = dict(yaml["neuralpoints"], weighted_first=False)
    st_n = RS.read(yaml)
    assert Y.decode_flops(st_n, 2) == 2 * (6 * 30 + 6 * 1601)
    # training: forward + backward of bs samples and the eikonal term's
    # six shifted decodes at every tenth
    assert Y.train_flops(st, 1, 100) == 3 * Y.decode_flops(st, 100 + 60)
    assert Y.track_flops(st, 3, 10) == 6 * Y.decode_flops(st, 10)


def test_mfu_and_idle_readers():
    run = _run([0.2] * 5, 1.0)
    flops = 5 * (Y.train_flops(run.settings, 12, 16384)
                 + Y.track_flops(run.settings, 4, 1000))
    assert H.load_metric("frame.mfu_pct").read(run) == pytest.approx(
        100 * flops / 1.0 / Y.PEAK_FP32_FLOPS)
    run.trace = {"busy_s": 0.25, "window_s": 1.0, "steps": 5,
                 "n_kernels": 500, "layers_device_s":
                 {"slambench.mapper": 0.1}}
    assert H.load_metric("device.idle_pct.frames").read(run) == \
        pytest.approx(75.0)
    assert H.load_metric("device.kernels_per_frame").read(run) == 100
    assert H.load_metric("mapper.device_ms").read(run) == pytest.approx(20)
