"""BENCHMARK.json keeps the shapes its format requires, and every cell,
configuration, traffic mix, metric and kernel count is found by name."""

import json
import re

import pytest

from zkbench.harness.spec import ROOT, Spec, SpecError
from zkbench.tests import toy_bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["zkbench"]
    assert BENCH["command"] == ["python3", "zkbench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


def _names():
    for key in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[key]:
            yield entry["name"]
    for w in BENCH["workloads"]:
        yield w["config"]
        yield w["traffic"]
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


def test_units_lines_and_keys():
    metrics = BENCH["end_to_end"] + BENCH["per_layer"]
    assert len({m["name"] for m in metrics}) == len(metrics)
    for m in metrics:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] == "artifact_s"
        assert "\n" not in m["layer"] and 1 <= len(m["layer"]) <= 200
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and 1 <= len(w["why"]) <= 200
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["source"].startswith("https://")
        for key in ("source", "why"):
            assert 1 <= len(c[key]) <= 200 and "\n" not in c[key]
    assert "setup_s" in {m["name"] for m in BENCH["end_to_end"]}


def test_every_cell_finds_its_files():
    spec = Spec()
    for w in BENCH["workloads"]:
        cfg = spec.config(w["config"])
        assert cfg["name"] == w["config"]
        assert spec.traffic(w["traffic"])["rows"] > 0
        assert spec.end_to_end(w["name"])
        for m in spec.per_layer(w["name"]):
            assert callable(spec.metric(m["name"]).read)
    for kernel in ("poseidon12", "digit_dot"):
        assert callable(spec.work(kernel).least_seconds)


def test_config_file_states_its_source():
    spec = Spec()
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]


def test_added_files_are_found_by_name():
    """A configuration, a traffic mix and a metric that only exist in the
    tests folder are found by their names, with no code changed."""
    metric = {"name": "toy.jobs", "unit": "jobs", "better": "higher",
              "source": "program_counter", "layer": "entry",
              "moves": "artifact_s"}
    spec = toy_bench.spec([metric])
    assert spec.config("toy-fib")["queries"] == 8
    assert spec.traffic("toy-512")["rows"] == 512
    assert spec.per_layer("toy-fib.2seg") == [metric]
    assert spec.metric("toy.jobs").read.__doc__ is None
    with pytest.raises(SpecError):
        spec.traffic("no-such-mix")
    with pytest.raises(SpecError):
        spec.cell("no-such-cell")
