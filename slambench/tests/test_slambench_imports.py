"""What a run and the reference load: no run loads jax, jaxlib, flax or
the JAX package (top-level names compared whole), and the reference loads
nothing of the program."""

import subprocess
import sys
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import harness as H  # noqa: E402

REPO = Path(__file__).resolve().parents[2]


def _python(code: str) -> subprocess.CompletedProcess:
    return subprocess.run([sys.executable, "-c", code], cwd=REPO,
                          capture_output=True, text=True, timeout=600)


def test_names_are_compared_whole(monkeypatch):
    for name in ("pin_slam_tpu_torch", "pin_slam_tpu_torch.ops",
                 "jaxtyping", "flax_like"):
        monkeypatch.setitem(sys.modules, name, object())
    assert H.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", object())
    monkeypatch.setitem(sys.modules, "pin_slam_tpu.ops", object())
    assert H.forbidden_modules() == ["jaxlib", "pin_slam_tpu"]


def test_the_reference_loads_nothing_of_the_program():
    r = _python(
        "import sys\n"
        "import slambench.reference.judge, slambench.reference.decode\n"
        "import slambench.reference.settings, slambench.yardstick\n"
        "import slambench.scene.frames, slambench.scene.cast_np\n"
        "bad = sorted({n.split('.')[0] for n in sys.modules} & "
        "{'pin_slam_tpu_torch', 'pin_slam_tpu', 'jax', 'jaxlib'})\n"
        "print(bad)\n")
    assert r.returncode == 0, r.stderr
    assert r.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    r = _python(
        "import sys, time, tempfile\n"
        "from pathlib import Path\n"
        "import torch\n"
        "torch.set_num_threads(2)\n"  # no oversubscription beside workers
        "from slambench import harness as H\n"
        "from slambench.tests import small\n"
        "small.run_small(Path(tempfile.mkdtemp()), 'kitti_cells.drive')\n"
        "print(H.forbidden_modules())\n")
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.strip().splitlines()[-1] == "[]"


def test_without_a_card_the_run_prints_no_result():
    r = subprocess.run([sys.executable, "slambench/run.py", "--workload",
                        "kitti_cells.drive", "--seed", "2147483999", "--seconds",
                        "1", "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=600)
    assert r.returncode != 0
    assert "correct" not in r.stdout
