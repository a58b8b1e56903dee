"""``BENCHMARK.json`` against the contract's shape, and every name in it
resolved to its file."""

import json
import re

import pytest
import torch

from benchmark.harness import cell as cells

BENCH = json.loads((cells.ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
CELLS = [w["name"] for w in BENCH["workloads"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "benchmark/run.py"]
    assert BENCH["paths"] == ["benchmark"]
    assert 1 <= BENCH["run_seconds"] <= 51
    cost = (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200
    assert cost <= 43200


def test_names_units_and_lengths():
    entries = BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"] \
        + BENCH["per_layer"]
    for e in entries:
        assert NAME.match(e["name"]), e["name"]
        for key in ("why", "layer", "source"):
            if key in e:
                assert 1 <= len(e[key]) <= 200, (e["name"], key)
                assert "\n" not in e[key] and "\t" not in e[key]
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for group in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))


def test_entry_keys():
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better",
                                          "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")


def test_cells_in_the_issues_order():
    assert CELLS == ["join_16m.sort", "tpch_sf10.captured",
                     "join_16m.hash", "tpch_sf10.eager"]


def test_every_cell_reports_setup_another_end_to_end_and_a_layer():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for name in CELLS:
        mine = [m for m in BENCH["end_to_end"] if cells.applies(m, name)]
        assert "setup_s" in {m["name"] for m in mine} and len(mine) >= 2
        layers = [m for m in BENCH["per_layer"] if cells.applies(m, name)]
        assert layers
        for m in layers:
            assert cells.applies(e2e[m["moves"]], name), (m["name"], name)


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("trace", [False, True])
def test_cell_resolves_to_its_files(name, trace):
    c = cells.resolve(name, trace)
    assert hasattr(c.kind, "Workload")
    assert hasattr(c.reference, "compare")
    group = BENCH["per_layer" if trace else "end_to_end"]
    assert {m["name"] for m, _ in c.metrics} == \
        {m["name"] for m in group if cells.applies(m, name)}
    for _, reader in c.metrics:
        assert callable(reader.read)
    assert set(c.config["limits"])


def test_config_files_state_their_cut():
    for entry in BENCH["configs"]:
        config = json.loads((cells.ROOT / entry["file"]).read_text())
        assert config["reduced"] == entry["reduced"]
        for key in entry["reduced"]:
            assert key in config and f"published_{key}" in config
        assert getattr(torch, config["control_precision"]).itemsize < \
            getattr(torch, config["precision"]).itemsize
        assert config["guarantees"] and config["assumed"]


def test_join_key_distributions_resolve_to_their_files():
    for entry in BENCH["configs"]:
        config = json.loads((cells.ROOT / entry["file"]).read_text())
        if config["kind"] == "join":
            path = cells.BENCH_DIR / "data" / "keys" / \
                f"{config['key']['distribution']}.py"
            assert callable(cells.load_module(path).draw), path
