"""The harness finds every piece of a cell by name, BENCHMARK.json keeps
to the contract's form, and a cell added as files alone runs."""

from __future__ import annotations

import importlib
import json
import os
import re

import pytest

from conftest import REPO, make_root, read_json
from portbench import harness, profiling, spec

BENCH = read_json("BENCHMARK.json")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_has_the_contract_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["portbench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    names = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    names += [c["name"] for c in BENCH["configs"] + BENCH["workloads"]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source",
                          "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and UNIT.match(m["unit"])
        assert m["source"] in ("host_clock", "device_trace")
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert m["moves"] in e2e and UNIT.match(m["unit"])
    for c in BENCH["workloads"]:
        assert set(c) == {"name", "config", "traffic", "chips", "why"}
        assert c["chips"] == 1 and len(c["why"]) <= 200


@pytest.mark.parametrize("workload", [w["name"] for w in BENCH["workloads"]])
def test_each_cell_finds_its_pieces(workload):
    cell = spec.load(REPO, workload)
    assert os.path.isdir(cell.config["model_dir"])
    assert cell.mix["streams"] == 4096
    assert [m["name"] for m in cell.end_to_end] == (
        ["realtime_streams", "card_streams", "setup_s"]
        if workload.startswith("f32-16k.") else ["card_streams", "setup_s"])
    for m in cell.per_layer:
        mod = importlib.import_module(f"portbench.metrics.{m['name']}")
        assert callable(mod.read)


@pytest.mark.parametrize("config", [c["name"] for c in BENCH["configs"]])
def test_each_configuration_file_is_its_own(config):
    (entry,) = [c for c in BENCH["configs"] if c["name"] == config]
    cfg = read_json(entry["file"])
    assert cfg["name"] == config and entry["reduced"] == []
    assert set(cfg["limits"]) >= {"code_gap", "bad_sizes", "lost_ticks"}


def test_a_cell_of_new_files_alone_runs(tmp_path, monkeypatch):
    """A new configuration, mix and cell: files and entries only.  The CPU
    has no device timeline; a busy time stands in for the card's."""
    recorded = profiling.recorded

    def on_a_card(*args, **kwargs):
        reading, windows = recorded(*args, **kwargs)
        return {**reading, "busy_s": 0.25}, windows

    monkeypatch.setattr(profiling, "recorded", on_a_card)
    root = make_root(tmp_path, config="lyra-v2-bf16-48k", mix="clean-b4096",
                     cell="new.cell", streams=4)
    result, notes = harness.run("new.cell", 2**31 + 11, 0.5, False,
                                root=root, device="cpu")
    assert set(result) == {"correct", "attempted", "failed", "metrics",
                           "device", "checks"}
    assert result["attempted"] > 0 and result["failed"] == 0
    assert set(result["metrics"]) == {"card_streams", "setup_s"}
    assert result["metrics"]["card_streams"]["value"] == pytest.approx(
        4 * harness.PROFILED_TICKS * 0.020 / 0.25)
    assert json.loads(json.dumps(result)) == result
