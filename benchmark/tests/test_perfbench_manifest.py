"""BENCHMARK.json against the contract's shape rules, and the files it names."""

import json
import re
from pathlib import Path

import pytest

from benchmark.core import named

ROOT = Path(__file__).resolve().parents[2]
M = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
METRICS = M["end_to_end"] + M["per_layer"]


def test_top_level_keys():
    assert set(M) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert M["paths"] == ["benchmark"] and M["command"] == ["python3", "benchmark/run.py"]
    assert len(json.dumps(M)) <= 64 * 1024


@pytest.mark.parametrize("name", [x["name"] for x in M["configs"] + M["workloads"] + METRICS]
                         + [w["traffic"] for w in M["workloads"]])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_shape(metric):
    assert UNIT.match(metric["unit"]) and metric["better"] in ("lower", "higher")
    allowed = {"name", "unit", "better", "source", "workloads"}
    if metric in M["end_to_end"]:
        assert set(metric) <= allowed | {"bound"} and metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= allowed | {"layer", "moves"}
        assert metric["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for key in ("layer",):
        if key in metric:
            assert 1 <= len(metric[key]) <= 200 and "\n" not in metric[key]


def test_unique_names():
    for group in (M["configs"], M["workloads"], METRICS):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert len({(w["config"], w["traffic"]) for w in M["workloads"]}) == len(M["workloads"])


def _reported(workload):
    return {m["name"] for m in M["end_to_end"] if workload in m.get("workloads", [workload])}


@pytest.mark.parametrize("metric", M["per_layer"], ids=lambda m: m["name"])
def test_moves_is_reported_where_the_metric_is(metric):
    assert metric["moves"] in {m["name"] for m in M["end_to_end"]}
    for w in metric["workloads"]:
        assert metric["moves"] in _reported(w), (metric["name"], w)
    assert (ROOT / "benchmark" / "layer_metrics" / f"{metric['name']}.py").exists()


@pytest.mark.parametrize("workload", M["workloads"], ids=lambda w: w["name"])
def test_every_cell_is_whole(workload):
    name = workload["name"]
    reported = _reported(name)
    assert "setup_s" in reported and len(reported) >= 2
    assert any(name in m.get("workloads", []) for m in M["per_layer"])
    assert workload["chips"] == 1 and 1 <= len(workload["why"]) <= 200
    base = ROOT / "benchmark"
    for path in (base / "traffic" / f"{workload['traffic']}.json", base / "limits" / f"{name}.json"):
        json.loads(path.read_text())
    assert workload["config"] in {c["name"] for c in M["configs"]}
    mix = json.loads((base / "traffic" / f"{workload['traffic']}.json").read_text())
    mode = named.load("modes", mix["mode"])
    assert callable(mode.run) and callable(mode.control_rows)
    if "arrivals" in mix:
        assert callable(named.load("arrivals", mix["arrivals"]).due)


@pytest.mark.parametrize("config", M["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert config["file"].startswith("benchmark/") and (ROOT / config["file"]).exists()
    body = json.loads((ROOT / config["file"]).read_text())
    assert body["source"] == config["source"] and body["reduced"] == config["reduced"] == []
    assert 1 <= len(config["why"]) <= 200 and 1 <= len(config["source"]) <= 200
    assert any(w["config"] == config["name"] for w in M["workloads"])


def test_run_seconds_fits_a_full_check():
    cells = 24
    total = (2 + 14 * cells) * (M["run_seconds"] + 60) + cells * 2 * 90 + 1200
    assert 1 <= M["run_seconds"] <= 51 and total <= 43200


def test_named_files_are_found_by_name_alone():
    assert named.load("modes", "closed") is named.load("modes", "closed")
    for bad in ("../run", "a/b", ""):
        with pytest.raises(ValueError):
            named.load("modes", bad)
    with pytest.raises(FileNotFoundError):
        named.load("arrivals", "no-such-process")


FAMILY_CONTRACT = ("program", "inputs", "call", "reference_images", "flops", "kernel_calls", "tiny")


@pytest.mark.parametrize("workload", M["workloads"], ids=lambda w: w["name"])
def test_every_cell_has_a_whole_family(workload):
    cfg = json.loads((ROOT / "benchmark" / "configs" / f"{workload['config']}.json").read_text())
    fam = named.family(cfg)
    assert fam is named.load("families", cfg.get("family", "audio_diffusion"))
    assert all(callable(getattr(fam, f, None)) for f in FAMILY_CONTRACT), fam
    mix = json.loads((ROOT / "benchmark" / "traffic" / f"{workload['traffic']}.json").read_text())
    if mix["mode"] == "open":
        assert callable(fam.served_inputs)
