"""Helpers of the benchmark's own tests (run them with
`python3 -m pytest portbench/tests -q` from the repository's root)."""

from __future__ import annotations

import json
import os

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
SMALL = os.path.join(REPO, "tests", "golden", "synthetic_lyra", "small")
FULL = os.path.join(REPO, "tests", "golden", "synthetic_lyra", "full")

torch.set_num_threads(2)  # the CPU runs are tiny; leave the cores be


def read_json(*parts):
    with open(os.path.join(REPO, *parts)) as f:
        return json.load(f)


def make_root(root, *, config="lyra-v2-f32-16k", mix="lossy-b4096",
              fixture=SMALL, streams=8, cell="tiny.cell", **changes) -> str:
    """A checkout-like directory holding one cell of a small size: the
    named configuration's file with `changes` (and the fixture), the
    named mix cut to `streams` streams with bursts every 10 ticks on every
    4th stream, and BENCHMARK.json's metrics."""
    root = str(root)
    os.makedirs(os.path.join(root, "portbench", "configs"), exist_ok=True)
    os.makedirs(os.path.join(root, "portbench", "traffic"), exist_ok=True)
    bench = read_json("BENCHMARK.json")
    cfg = read_json("portbench", "configs", config + ".json")
    cfg.update(fixture=fixture, **changes)
    m = read_json("portbench", "traffic", mix + ".json")
    m.update(streams=streams, pool_ticks=4)
    if m["loss"]["burst_every"]:
        m["loss"].update(burst_every=10, burst_hops=4, burst_stride=4)
    with open(os.path.join(root, "portbench", "configs", "tiny.json"),
              "w") as f:
        json.dump(cfg, f)
    with open(os.path.join(root, "portbench", "traffic", "tiny-mix.json"),
              "w") as f:
        json.dump(m, f)
    bench["configs"] = [{"name": "tiny", "source": cfg["source"],
                         "file": "portbench/configs/tiny.json",
                         "reduced": [], "why": "a test's"}]
    bench["workloads"] = [{"name": cell, "config": "tiny",
                           "traffic": "tiny-mix", "chips": 1,
                           "why": "a test's"}]
    with open(os.path.join(root, "BENCHMARK.json"), "w") as f:
        json.dump(bench, f)
    return root


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the port's CUDA kernels and TF32 "
                    "have no CPU mode")
    return torch.device("cuda")
