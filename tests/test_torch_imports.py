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
    from pin_slam_tpu_torch.config import Config
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    for opt in ("semantic_on", "dynamic_filter_on"):
        c = Config()
        setattr(c, opt, True)
        with pytest.raises(NotImplementedError, match=opt):
            PinSLAMSystem(c.finalize(), device="cpu")
    c = Config()
    c.probe_mode = "cells"
    with pytest.raises(NotImplementedError, match="join"):
        PinSLAMSystem(c.finalize(), device="cpu")
