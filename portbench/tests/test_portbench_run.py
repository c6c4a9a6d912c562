"""A whole run on the CPU at a tiny size: the command's refusals and the
result line's keys."""

from __future__ import annotations

import functools
import json
import os
import shutil
import subprocess
import sys
import types

import pytest
import torch

import portbench.__main__ as cli
from conftest import REPO, make_root
from portbench import harness

# The tiny cell's end-to-end metrics: those BENCHMARK.json gives every
# cell.  card_streams reads the card's busy time, which a CPU run has not.
E2E = {"setup_s"}


def _cli(monkeypatch, capsys, root, trace):
    """main() on a tiny cell, with the card stood in by the CPU."""
    monkeypatch.chdir(root)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(harness, "run",
                        functools.partial(harness.run, device="cpu"))
    rc = cli.main(["--workload", "tiny.cell", "--seed", str(2**31 + 5),
                   "--seconds", "0.5", "--trace", str(trace)])
    out, err = capsys.readouterr()
    return rc, out, err


@pytest.mark.parametrize("trace", [0, 1])
def test_last_line_has_the_contract_keys(tmp_path, monkeypatch, capsys,
                                         trace):
    rc, out, err = _cli(monkeypatch, capsys, make_root(tmp_path), trace)
    assert rc == 0
    line = json.loads(out.strip().splitlines()[-1])
    keys = ["correct", "attempted", "failed", "metrics", "device", "checks"]
    if trace:
        keys.insert(3, "breakdown")
    assert sorted(line) == sorted(keys) and list(line)[-1] == "checks"
    assert set(line["device"]) >= {"platform", "kind", "count",
                                   "memory_peak_bytes"}
    if trace:
        assert set(line["device"]) >= {"busy_s", "window_s"}
        assert set(line["metrics"]) <= {
            "served_streams", "hop_p95_ms", "server_host_ms", "kernels_per_tick", "device_idle_pct",
            "engine_ops_device_ms", "conv_stack_device_ms",
            "conv_stack_roofline", "rvq_encode_roofline", "tick_mfu_pct"}
        assert set(line["breakdown"]) == {"device_ops", "idle_gaps"}
    else:
        assert set(line["metrics"]) == E2E
    for m in line["metrics"].values():
        assert set(m) == {"value", "unit"}
    last = err.strip().splitlines()[-len(line["checks"]):]
    assert all(s.startswith("check ") and "limit" in s for s in last)


def test_refuses_a_run_that_loaded_jax(tmp_path, monkeypatch, capsys):
    monkeypatch.setitem(sys.modules, "jax", types.ModuleType("jax"))
    rc, out, _ = _cli(monkeypatch, capsys, make_root(tmp_path), 0)
    assert rc == 3 and out == ""


def _run_cli(cwd):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    env["PYTHONPATH"] = ""
    return subprocess.run(
        [sys.executable, "-m", "portbench", "--workload",
         "f32-16k.lossy-b4096", "--seed", "1", "--seconds", "1",
         "--trace", "0"], cwd=cwd, env=env, capture_output=True, text=True,
        timeout=120)


def test_without_a_card_prints_no_result():
    proc = _run_cli(REPO)
    assert proc.returncode == 2 and proc.stdout == ""


def test_the_benchmark_alone_prints_no_result(tmp_path):
    shutil.copy(os.path.join(REPO, "BENCHMARK.json"), tmp_path)
    shutil.copytree(os.path.join(REPO, "portbench"),
                    os.path.join(tmp_path, "portbench"),
                    ignore=shutil.ignore_patterns("__pycache__"))
    proc = _run_cli(tmp_path)
    assert proc.returncode != 0 and proc.stdout == ""
