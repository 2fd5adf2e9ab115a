"""The port stands alone: importing every module of pin_slam_tpu_torch in a
fresh interpreter loads neither jax nor anything of pin_slam_tpu, and the
entry points refuse to fall back to the CPU on their own."""

import pkgutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import pin_slam_tpu_torch

ROOT = Path(__file__).resolve().parents[1]


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages(
        pin_slam_tpu_torch.__path__, "pin_slam_tpu_torch."))


def test_every_module_listed():
    mods = _modules()
    for m in ("ops.knn_join", "models.neural_points", "slam.system",
              "slam.tracker", "slam.mapper", "convert", "device", "config"):
        assert f"pin_slam_tpu_torch.{m}" in mods


@pytest.mark.parametrize("mod", [
    "ops.fused_decode", "ops.marching", "slam.mesher", "slam.map_query",
    "utils.eval_mesh", "ops.cuda_build"])
def test_mesh_slice_modules_listed(mod):
    """The modules of the map -> mesh slice are walked by the import check
    below (a package without an __init__.py would be skipped silently)."""
    assert f"pin_slam_tpu_torch.{mod}" in _modules()


@pytest.mark.parametrize("mod", [
    "slam.loop", "slam.pgo", "slam.loop_detector", "utils.eval_traj"])
def test_loop_slice_modules_listed(mod):
    """The modules of the loop-closure slice are walked by the import
    check below, so none of them loads jax or the JAX package."""
    assert f"pin_slam_tpu_torch.{mod}" in _modules()


@pytest.mark.parametrize("mod", [
    "utils.semantic_kitti_utils", "dataset.synthetic", "models.decoder",
    "models.losses", "models.sampler"])
def test_color_semantic_slice_modules_listed(mod):
    """The modules of the colour and semantic slice, the port's own copy of
    the SemanticKITTI utilities among them, are walked by the import check
    below, so none of them loads jax or the JAX package."""
    assert f"pin_slam_tpu_torch.{mod}" in _modules()


@pytest.mark.parametrize("mod", [
    "run", "vis_map", "utils.map_io", "utils.logger", "dataset.io",
    "dataset.slam_dataset", "dataset.dataset_indexing",
    "dataset.dataloaders", "dataset.dataloaders.generic",
    "dataset.dataloaders.kitti", "dataset.dataloaders.colorize"])
def test_entry_point_slice_modules_listed(mod):
    """The modules of the entry-point slice (the CLI, map save / load, the
    host dataset layer) are walked by the import check below, so none of
    them loads jax or the JAX package."""
    assert f"pin_slam_tpu_torch.{mod}" in _modules()


DATASET_SLICE = [
    "utils.point_cloud2", "dataset.rosbag1", "dataset.mcap1",
    "dataset.converter", "dataset.converter.to_pin_format"] + [
    f"dataset.dataloaders.{m}" for m in (
        "rosbag", "mcap", "ouster", "ncd", "mulran", "colorize", "kitti_raw",
        "kitti360", "kitti_mot", "nclt", "boreas", "apollo", "paris_luco",
        "helipr", "nuscenes", "rgbd_utils", "replica", "tum")]


@pytest.mark.parametrize("mod", DATASET_SLICE)
def test_dataset_slice_modules_listed(mod):
    """The modules of the data-loader slice (the loaders, the ROS1 bag,
    MCAP and pcap readers, the converter) are walked by the import checks
    here, so none of them loads jax, the JAX package, PIL or ROS."""
    assert f"pin_slam_tpu_torch.{mod}" in _modules()


@pytest.mark.parametrize("mod", ["ops.range_image", "models.pos_encoding"])
def test_option_slice_modules_listed(mod):
    """The modules of the training options (incidence labels, positional
    encodings) are walked by the import checks here, so neither loads jax
    or the JAX package."""
    assert f"pin_slam_tpu_torch.{mod}" in _modules()


def test_every_module_imports_without_pil_and_ros():
    """With PIL and sensor_msgs blocked, every module of the port still
    imports: the loaders import them where a frame or a message needs
    them, and that call raises ImportError naming the package."""
    code = (
        "import importlib, sys\n"
        "sys.modules['PIL'] = None\n"
        "sys.modules['sensor_msgs'] = None\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "from pin_slam_tpu_torch.dataset.dataloaders import rgbd_utils\n"
        "from pin_slam_tpu_torch.utils import point_cloud2\n"
        "for call in (lambda: rgbd_utils.backproject_rgbd("
        "'a', 'b', 1, 1, 0, 0, 1.0),\n"
        "             lambda: point_cloud2.make_point_cloud2("
        "[[0.0, 0, 0]])):\n"
        "    try:\n"
        "        call()\n"
        "    except ImportError as e:\n"
        "        print('RAISED', e)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    raised = out.stdout.splitlines()
    assert len(raised) == 2, out.stdout
    assert "PIL" in raised[0] and "sensor_msgs" in raised[1], out.stdout


def test_run_imports_no_plotting_or_image_library():
    """The CLI and its dataset layer load matplotlib and PIL only where a
    feature needs them (PIL: the KITTI loader's camera colours)."""
    code = (
        "import sys\n"
        "import pin_slam_tpu_torch.run, pin_slam_tpu_torch.vis_map\n"
        "import pin_slam_tpu_torch.dataset.slam_dataset\n"
        "import pin_slam_tpu_torch.dataset.dataloaders.kitti\n"
        "bad = sorted(k for k in sys.modules if k.split('.')[0] in "
        "('matplotlib', 'PIL', 'jax', 'pin_slam_tpu'))\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_chip_smoke_imports_torch_package_only():
    import ast
    tree = ast.parse((ROOT / "chip_smoke.py").read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            names.add(node.module or "")
    roots = {n.split(".")[0] for n in names}
    assert "jax" not in roots and "pin_slam_tpu" not in roots
    assert "pin_slam_tpu_torch" in roots


def test_no_jax_and_no_reference_package_loaded():
    code = (
        "import importlib, sys\n"
        f"for m in {_modules()!r}:\n"
        "    importlib.import_module(m)\n"
        "bad = sorted(k for k in sys.modules if k == 'jax'"
        " or k.startswith('jax.') or k == 'pin_slam_tpu'"
        " or k.startswith('pin_slam_tpu.'))\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert "LOADED []" in out.stdout, out.stdout


def test_cuda_entry_point_raises_without_a_card(monkeypatch):
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.device import resolve_device
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PinSLAMSystem(Config().finalize())
    assert resolve_device("cpu").type == "cpu"


def test_full_fp32_is_pinned():
    from pin_slam_tpu_torch.device import resolve_device

    resolve_device("cpu")
    assert torch.backends.cuda.matmul.allow_tf32 is False
    assert torch.backends.cudnn.allow_tf32 is False
    assert torch.get_float32_matmul_precision() == "highest"


def test_unported_options_raise():
    """No option of the JAX package is refused any more: a `dp_on` system
    builds, single-device without a second device (the JAX package's rule)
    and over the replicas it is given; the cell and brick probes, incidence
    labels, the consistency loss and the projective correction build a
    system (a brick system keeps the brick cache, the others the dump brick
    alone)."""
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.models.neural_points import has_btable
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    def small():
        c = Config()
        c.map_capacity, c.buffer_size = 1 << 12, 1 << 14
        c.pool_capacity = 1 << 12
        return c

    c = small()
    c.dp_on = True
    assert PinSLAMSystem(c.finalize(), device="cpu").mesh is None
    system = PinSLAMSystem(c, device="cpu", mesh=["cpu", "cpu"])
    assert system.mesh == [torch.device("cpu")] * 2
    for field, value in (("probe_mode", "cells"), ("probe_mode", "brick"),
                         ("incidence_label_on", True),
                         ("consistency_loss_on", True),
                         ("proj_correction_on", True)):
        c = small()
        setattr(c, field, value)
        system = PinSLAMSystem(c.finalize(), device="cpu")
        assert has_btable(system.state) == (value == "brick")
        assert system.mesh is None


def _jax_modules():
    root = ROOT / "pin_slam_tpu"
    return sorted(str(p.relative_to(root)) for p in root.rglob("*.py"))


@pytest.mark.parametrize("rel", _jax_modules())
def test_every_jax_module_has_a_counterpart(rel):
    """Every module of the JAX package has a port counterpart at the same
    relative path (the Pallas decode's is ops/fused_decode.py)."""
    rel = {"ops/pallas_decode.py": "ops/fused_decode.py"}.get(rel, rel)
    assert (ROOT / "pin_slam_tpu_torch" / rel).is_file(), rel


@pytest.mark.parametrize("mod", [
    "utils.plots", "utils.visualizer", "gui", "gui.gui_utils",
    "gui.slam_viewer", "gui.o3d_gui", "parallel", "parallel.dp",
    "pin_slam_ros"])
def test_viewer_dp_ros_modules_listed(mod):
    """The modules of the last slice (plots, the visualizer and the viewer
    process, data parallelism, the ROS node) are walked by the import
    checks here, so none of them loads jax or the JAX package."""
    assert f"pin_slam_tpu_torch.{mod}" in _modules()


def test_new_modules_import_without_ros_open3d_and_matplotlib():
    """With rospy, the ROS message packages, open3d and matplotlib blocked,
    the viewer, plot, data-parallel and ROS modules import (they import
    those where a call needs them), the viewer's package loads no torch
    (its spawned process never touches the card), and the ROS node's
    constructor raises ImportError naming rospy."""
    blocked = ("rospy", "nav_msgs", "geometry_msgs", "sensor_msgs",
               "tf2_ros", "std_srvs", "open3d", "matplotlib")
    code = (
        "import importlib, sys\n"
        f"for b in {blocked!r}:\n"
        "    sys.modules[b] = None\n"
        "import pin_slam_tpu_torch.gui, pin_slam_tpu_torch.gui.o3d_gui\n"
        "import pin_slam_tpu_torch.utils.visualizer\n"
        "print('TORCH', 'torch' in sys.modules)\n"
        "from pin_slam_tpu_torch.gui import o3d_gui\n"
        "print('O3D', o3d_gui.available())\n"
        "for m in ('utils.plots', 'parallel.dp', 'pin_slam_ros'):\n"
        "    importlib.import_module('pin_slam_tpu_torch.' + m)\n"
        "from pin_slam_tpu_torch.pin_slam_ros import PINSLAMRosNode\n"
        "from pin_slam_tpu_torch.config import Config\n"
        "try:\n"
        "    PINSLAMRosNode(Config().finalize(), device='cpu')\n"
        "except ImportError as e:\n"
        "    print('RAISED', e)\n"
        "bad = sorted(k for k, v in sys.modules.items() if v is not None "
        "and k.split('.')[0] in "
        "('jax', 'pin_slam_tpu', 'matplotlib', 'open3d', 'rospy'))\n"
        "print('LOADED', bad)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    lines = out.stdout.splitlines()
    assert "TORCH False" in lines and "O3D False" in lines, out.stdout
    assert any(ln.startswith("RAISED") and "rospy" in ln for ln in lines)
    assert "LOADED []" in lines, out.stdout
