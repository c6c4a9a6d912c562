"""The traced stretch (portbench/traced.py) and the nine metrics that read
it: each reader on a synthetic reading, a checkout without the port's
tracer, and the tiny cell on the CPU with `--trace 1`."""

from __future__ import annotations

import importlib
import json
import os
import sys

import pytest
import torch

from conftest import make_root
from portbench import harness, traced

HOST = ("server_stage_ms", "server_launch_ms", "server_drain_ms",
        "server_wait_ms", "plc_cng_useful_pct")
DEVICE = ("conv_edges_device_ms", "plc_cng_device_ms",
          "resampler_device_ms", "state_copy_device_ms")

READING = {
    "host_ms": {"enc.stage": 0.5, "dec.stage": 0.25, "dec.unpack": 0.125,
                "graph.replay": 0.0625, "enc.drain": 1.0, "dec.drain": 2.0,
                "host.wait": 3.0, "enc.tick": 9.0},
    "segments_ms": {"gan.prologue": 0.1, "gan.epilogue": 0.2,
                    "ss.prologue": 0.3, "ss.epilogue": 0.4, "dec.plc": 1.0,
                    "dec.cng": 2.0, "dec.crossfade": 4.0, "dec.noise": 8.0,
                    "enc.resample": 0.5, "dec.resample": 0.25,
                    "graph.state_copy": 0.03, "dec.gan_select": 0.02,
                    "enc.ss_select": 0.01, "gan.core": 5.0},
    "counts": {"dec.rows_run": 4000, "dec.rows_concealed": 300,
               "dec.rows_comfort_noise": 100, "enc.rows_dtx": 0},
}
EXPECTED = {
    "server_stage_ms": 0.875, "server_launch_ms": 0.0625,
    "server_drain_ms": 3.0, "server_wait_ms": 3.0,
    "conv_edges_device_ms": 1.0, "plc_cng_device_ms": 15.0,
    "resampler_device_ms": 0.75, "state_copy_device_ms": 0.06,
    "plc_cng_useful_pct": 10.0,
}


def _read(name, ctx):
    return importlib.import_module(f"portbench.metrics.{name}").read(ctx)


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_metric_reads_the_stretch(name):
    assert _read(name, {"traced": READING}) == pytest.approx(EXPECTED[name])


@pytest.mark.parametrize("name", sorted(EXPECTED))
def test_each_metric_is_silent_without_a_reading(name):
    empty = {"host_ms": {}, "segments_ms": {}, "counts": {}}
    assert _read(name, {"traced": None}) is None
    assert _read(name, {"traced": empty}) is None


def test_a_port_without_the_tracer_gives_no_reading(monkeypatch):
    """The parent's checkout: lyra_tpu_torch has no utils/trace.py, so no
    server is built and every metric is left out."""
    import lyra_tpu_torch.utils

    monkeypatch.setitem(sys.modules, "lyra_tpu_torch.utils.trace", None)
    monkeypatch.delattr(lyra_tpu_torch.utils, "trace", raising=False)
    ctx = {"profile": {"kernels": 0}}
    assert traced.reading(ctx) is None and ctx["traced"] is None
    for name in EXPECTED:
        assert _read(name, ctx) is None


def test_the_tiny_cell_traced_on_the_cpu(tmp_path, capsys, monkeypatch):
    """The host metrics and the counters' share from a CPU run; the CPU has
    no device timeline, so no device metric.  The stretch takes the card
    where the process has used it, so the test keeps it unused."""
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    root = make_root(tmp_path, config="lyra-v2-bf16-48k", streams=8)
    path = os.path.join(root, "BENCHMARK.json")
    with open(path) as f:
        bench = json.load(f)
    for m in bench["per_layer"]:
        if m["name"] in EXPECTED:
            m["workloads"] = ["tiny.cell"]
    with open(path, "w") as f:
        json.dump(bench, f)
    result, _ = harness.run("tiny.cell", 2**31 + 23, 0.5, True, root=root,
                            device="cpu")
    got = result["metrics"]
    assert set(HOST) <= set(got) and not set(DEVICE) & set(got)
    for name in HOST[:4]:
        assert got[name]["unit"] == "ms/tick" and got[name]["value"] >= 0
    assert got["server_stage_ms"]["value"] > 0
    assert 0 < got["plc_cng_useful_pct"]["value"] < 100
    err = capsys.readouterr().err
    assert "traced stretch: 20 ticks" in err
    assert "graph.captures in the timed stretches 0, in the profiled one 0" \
        in err
    assert "host dec.drain" in err and "counters: dec.rows_comfort_noise" \
        in err
