"""BENCHMARK.json against the benchmark's contract: names, units and
keys, the files it names, and that every per-layer metric's end-to-end
metric is reported in each of its cells."""

import json
import re
import sys
from pathlib import Path

import pytest

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

from slambench import harness as H  # noqa: E402

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(_dim|_rank)$|hidden|intermediate|latent|head")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["slambench"]
    assert BENCH["command"] == ["python3", "slambench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51


def test_a_full_check_fits_its_time_with_24_cells():
    rs = BENCH["run_seconds"]
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end",
                                   "per_layer"])
def test_names_and_units_use_the_allowed_characters(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e and group not in ("end_to_end", "per_layer") \
                    or key in ("why", "layer") and key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key]


def test_metric_names_are_unique_across_groups():
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(names) == len(set(names))


def test_configs_point_at_their_files_and_cut_no_width():
    used = {w["config"] for w in BENCH["workloads"]}
    for c in BENCH["configs"]:
        assert c["name"] in used
        path = REPO / c["file"]
        assert path.is_file() and c["file"].startswith("slambench/")
        spec = json.loads(path.read_text())
        assert spec["name"] == c["name"]
        assert spec["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert NAME.match(key) and not WIDTH.search(key), key
        assert c["source"].startswith("https://")


def test_every_cell_finds_its_files_and_takes_one_chip():
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
        H.load_json("configs", w["config"])
        H.load_json("traffic", w["traffic"])
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))


def test_end_to_end_metrics_and_bounds():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    assert e2e["setup_s"]["bound"] == 0.25 and "workloads" not in \
        e2e["setup_s"]
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    for w in BENCH["workloads"]:
        e2e = H.metrics_of(BENCH, w["name"], False)
        assert "setup_s" in [m["name"] for m in e2e] and len(e2e) >= 2
        assert H.metrics_of(BENCH, w["name"], True)


def test_each_layer_metric_moves_what_its_cells_report():
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        for cell in m["workloads"]:
            reported = [e["name"] for e in H.metrics_of(BENCH, cell, False)]
            assert m["moves"] in reported, (m["name"], cell)


def test_every_metric_has_a_reader_and_every_limit_a_reading():
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert hasattr(H.load_metric(m["name"]), "read")
    lim = H.limits()
    assert set(lim) == {"track_sdf_gap_m", "train_loss_rel",
                        "train_grad_rel", "train_step_rel",
                        "train_batch_rows_off", "pose_step_m",
                        "pose_step_deg"}
    assert all(v > 0 for k, v in lim.items() if k != "train_batch_rows_off")
    assert lim["train_batch_rows_off"] == 0


def test_the_file_is_small():
    assert (REPO / "BENCHMARK.json").stat().st_size <= 64 * 1024
