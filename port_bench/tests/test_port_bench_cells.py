"""The benchmark's files: every cell, configuration and metric is found by
its name, and BENCHMARK.json keeps to the contract's shapes."""

import importlib
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["port_bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("section", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units(section):
    names = [e["name"] for e in BENCH[section]]
    assert len(names) == len(set(names))
    for e in BENCH[section]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]), e["unit"]
            assert e["better"] in ("lower", "higher")
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200 and "\n" not in e[key] and "\t" not in e[key]


@pytest.mark.parametrize("cell", [w["name"] for w in BENCH["workloads"]])
def test_cell_files_found_by_name(cell):
    from port_bench.harness import load_cell
    c = load_cell(cell)
    assert c.entry["chips"] == 1
    importlib.import_module(f"port_bench.drivers.{c.workload['driver']}")
    assert set(c.workload["limits"]) and all(v >= 0 for v in c.workload["limits"].values())
    reported = {m["name"] for m in c.metrics("end_to_end")}
    assert "setup_s" in reported and len(reported) >= 2
    assert c.metrics("per_layer")


@pytest.mark.parametrize("metric", [m["name"] for m in BENCH["per_layer"]])
def test_metric_reader_found_by_name(metric):
    from port_bench.harness import _reader
    m = next(x for x in BENCH["per_layer"] if x["name"] == metric)
    assert callable(_reader(metric).read)
    assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    assert set(m["workloads"]) <= cells
    moved = next(e for e in BENCH["end_to_end"] if e["name"] == m["moves"])
    assert set(m["workloads"]) <= set(moved.get("workloads", cells))


def test_bounds_within_contract():
    for e in BENCH["end_to_end"]:
        assert 0.01 <= e["bound"] <= 0.25
        assert e["source"] in ("host_clock", "device_trace")
    assert next(e for e in BENCH["end_to_end"] if e["name"] == "setup_s")["bound"] <= 0.25


def test_config_files_hold_what_the_port_reads(tiny_cell):
    """Each configuration's file states what the port's config file gives."""
    from port_bench.drivers.common import port_config
    for c in BENCH["configs"]:
        cell = next(w["name"] for w in BENCH["workloads"] if w["config"] == c["name"])
        port_config(tiny_cell(cell))
