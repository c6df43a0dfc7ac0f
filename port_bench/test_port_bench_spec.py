"""BENCHMARK.json and the files it names: every cell, configuration and
metric is found by name, and the file keeps to the benchmark's contract."""

from __future__ import annotations

import json
import re

import pytest

from port_bench import spec

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "port_bench/run.py"]
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("section", sorted(ENTRY_KEYS))
def test_entries_have_just_their_keys_and_plain_names(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    may_add = {"workloads"} if section in ("end_to_end", "per_layer") else set()
    for e in BENCH[section]:
        assert ENTRY_KEYS[section] <= set(e) <= ENTRY_KEYS[section] | may_add
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher")
        for cell in e.get("workloads", ()):
            assert cell in {w["name"] for w in BENCH["workloads"]}


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_is_found_by_name(cell):
    c = spec.cell(cell)
    assert c.chips == 1
    assert c.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == cell)
    assert {"rows_per_call", "in_flight", "callers", "distinct_rows", "call_layouts",
            "mix"} <= set(c.traffic)
    assert set(c.traffic["mix"]) <= set(c.config["schemes"])
    reported = {m["name"] for m in c.end_to_end}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.per_layer
    for m in c.per_layer:
        assert m["moves"] in reported


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_each_configuration_is_a_file_of_its_own(config):
    assert config["file"].startswith("port_bench/configs/")
    data = json.loads((spec.ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["source"] == config["source"]
    assert data["reduced"] == config["reduced"] == []
    assert config["source"].startswith("https://")
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(config["file"]) == 1
    assert any(w["config"] == config["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_each_metric_has_a_reader_found_by_name(metric):
    module = spec.reader(metric["name"])
    assert callable(module.read)
    assert module.MOVES == metric.get("moves")
    if metric["name"].endswith("_roofline"):
        assert metric["unit"] == "%"


def test_bounds_and_sources():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    assert next(m for m in BENCH["end_to_end"] if m["name"] == "setup_s")["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")


def test_layers_name_one_layer_letter_for_letter():
    by_layer: dict = {}
    for m in BENCH["per_layer"]:
        by_layer.setdefault(m["layer"], []).append(m["name"])
    assert by_layer[next(m["layer"] for m in BENCH["per_layer"]
                         if m["name"] == "verify_roofline")] == ["verify_roofline",
                                                                 "chunk_device_ms"]


def test_an_unknown_cell_names_the_known_ones():
    with pytest.raises(KeyError, match="p256.call1024"):
        spec.cell("no.such.cell")
