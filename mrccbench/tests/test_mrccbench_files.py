"""Every cell, configuration, traffic mix and metric that
``BENCHMARK.json`` names loads by its name, and agrees with its entry."""

import re

import pytest

from mrccbench.harness import registry

BENCH = registry.benchmark()
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


@pytest.mark.parametrize("entry", BENCH["workloads"],
                         ids=lambda e: e["name"])
def test_cell_files_load_by_name(entry):
    cell = registry.workload(entry["name"])
    for key in ("config", "traffic", "chips", "why"):
        assert cell[key] == entry[key]
    config = registry.config(cell["config"])
    mix = registry.traffic(cell["traffic"])
    assert callable(registry.kind(mix["kind"]).run)
    assert set(cell["limits"]) and all(v > 0 for v in cell["limits"].values())
    assert config["name"] == cell["config"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda e: e["name"])
def test_config_files_agree(entry):
    config = registry.config(entry["name"])
    assert entry["file"] == f"mrccbench/configs/{entry['name']}.json"
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]


@pytest.mark.parametrize("entry", BENCH["per_layer"], ids=lambda e: e["name"])
def test_metric_readers_load_by_name(entry):
    reader = registry.metric(entry["name"])
    assert reader.LAYER == entry["layer"]
    assert reader.MOVES == entry["moves"]
    assert reader.read({}) is None  # nothing to read: no number
    moves = {m["name"] for m in BENCH["end_to_end"]}
    assert entry["moves"] in moves


def test_names_and_bounds_keep_to_the_contract():
    names = [e["name"] for s in ("configs", "workloads", "end_to_end",
                                 "per_layer") for e in BENCH[s]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    assert {m["name"] for m in BENCH["end_to_end"]} >= {"setup_s"}
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert 1 <= BENCH["run_seconds"] <= 51
    assert BENCH["command"] == ["python3", "mrccbench/run.py"]
    assert BENCH["paths"] == ["mrccbench"]
