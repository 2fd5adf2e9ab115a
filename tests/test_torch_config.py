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


MESH_FIELDS = ("mc_res_m", "pad_voxel", "skip_top_voxel", "mc_mask_on",
               "mesh_min_nn", "min_cluster_vertices", "infer_bs",
               "infer_bs_final", "save_mesh", "mesh_freq_frame")


@pytest.mark.parametrize("field", MESH_FIELDS)
def test_mesh_field_kept_and_loaded_alike(field):
    """Each field the mesher reads is a field of the port's Config, and
    over every YAML of the repo it loads to the JAX package's value."""
    assert field in {f.name for f in dataclasses.fields(TConfig)}
    seen = set()
    for path in YAMLS:
        t, j = TConfig().load(path), JConfig().load(path)
        assert getattr(t, field) == getattr(j, field), path
        seen.add(getattr(t, field))
    assert seen


def test_infer_bs_final_follows_bs():
    c = TConfig()
    c.bs = 16384
    assert c.finalize().infer_bs_final == 32 * 16384 == 524288


@pytest.mark.parametrize("mode", ["auto", "join", "cells"])
def test_probe_modes_accepted_by_query_params(mode):
    from pin_slam_tpu_torch.slam.map_query import make_query_params

    c = TConfig()
    c.probe_mode = mode
    qp = make_query_params(c.finalize())
    assert qp.probe_mode == ("cells" if mode == "cells" else "join")
    assert len(qp.offsets) == 33


def test_brick_probe_is_refused():
    from pin_slam_tpu_torch.slam.map_query import make_query_params

    c = TConfig()
    c.probe_mode = "brick"
    with pytest.raises(NotImplementedError, match="brick"):
        make_query_params(c.finalize())


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
