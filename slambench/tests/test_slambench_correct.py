"""`correct` against its control and its faults, at a size the CPU holds:
a sound run reads correct, the control (the reference in TF32 in the
program's place) reads above every limit that was set from it, and each
fault planted under the timed path (`slambench/faults.py`) turns `correct`
false. The card test reads the control at the cell's own size."""

import sys
import time
from pathlib import Path

import pytest
import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import faults as F  # noqa: E402
from slambench import harness as H  # noqa: E402
from slambench.tests import small  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def few_threads():
    n = torch.get_num_threads()
    torch.set_num_threads(4)
    yield
    torch.set_num_threads(n)


def _from_control():
    return [k for k, v in H.set_from().items() if v == "control"]


def test_a_sound_run_is_correct_and_the_control_is_not(tmp_path):
    r = small.run_small(tmp_path, "kitti_cells.drive", control=True)
    assert r["correct"], r["checks"]
    lim = H.limits()
    for name in _from_control():
        assert r["control"][name] > lim[name], (name, r["control"][name])


@pytest.mark.parametrize("fault", F.FRAME_FAULTS)
def test_a_fault_under_the_frame_loop_fails(tmp_path, monkeypatch, fault):
    F.plant(fault, monkeypatch)
    r = small.run_small(tmp_path, "kitti_cells.drive")
    assert not r["correct"], r["checks"]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")


@pytest.mark.cuda
def test_the_control_fails_at_the_cells_own_size(card):
    bench = H.load_bench()
    cell = H.cell_of(bench, "kitti_cells.drive")
    lim = H.limits()
    for seed in (2147483701, 2147483702, 2147483703):
        r = H.run_cell(bench, cell, seed, 5, False, "cuda",
                       time.perf_counter(), log=lambda *a: None,
                       control=True)
        assert r["correct"], r["checks"]
        for name in _from_control():
            assert r["control"][name] > lim[name], (name, seed)
