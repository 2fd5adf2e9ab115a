"""The port's config against the JAX package's: same defaults, and every
YAML of the repo loads to the same values in every field the port keeps."""

import dataclasses
import glob
import os

import pytest

from pin_slam_tpu.config import Config as JConfig
from pin_slam_tpu_torch.config import Config as TConfig

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
YAMLS = sorted(glob.glob(os.path.join(ROOT, "config", "*", "*.yaml")))


def _fields(c):
    return {f.name: getattr(c, f.name) for f in dataclasses.fields(TConfig)}


def test_defaults_match():
    assert _fields(TConfig().finalize()) == _fields(JConfig().finalize())
    assert TConfig().sdf_scale == JConfig().sdf_scale
    assert TConfig().all_sample_n == JConfig().all_sample_n


@pytest.mark.parametrize("path", YAMLS,
                         ids=[os.path.relpath(p, ROOT) for p in YAMLS])
def test_yaml_loads_alike(path):
    t, j = TConfig().load(path), JConfig().load(path)
    assert _fields(t) == _fields(j)
    assert t.sdf_scale == j.sdf_scale


def test_unported_yaml_features_are_refused():
    from pin_slam_tpu_torch.slam.system import PinSLAMSystem

    refused = 0
    for path in YAMLS:
        c = TConfig().load(path)
        if c.semantic_on or c.color_on or c.dynamic_filter_on:
            refused += 1
            with pytest.raises(NotImplementedError):
                PinSLAMSystem(c, device="cpu")
    assert refused > 0
