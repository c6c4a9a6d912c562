"""Finding a cell's pieces by name.

BENCHMARK.json (at the checkout's root) names the cell: its configuration
(whose entry gives the file of sizes) and its traffic mix
(portbench/traffic/<traffic>.json).  Its metrics are the end-to-end and
per-layer entries whose `workloads` list the cell, or that have no such
list; a per-layer metric's reader is portbench/metrics/<name>.py.  A new
cell, configuration, mix or metric is new files and new entries: nothing
here changes.

A configuration's file says what the harness would otherwise assume of
one codec (REQUIRED): its hop, the port's engine classes the servers run,
the plain reference that judges them, and the class that counts a tick's
work.  Classes and modules are named by import path from the checkout's
root, a class as "<module>:<class>".
"""

from __future__ import annotations

import dataclasses
import importlib
import json
import os
from typing import List

REQUIRED = ("hop_ms", "engines", "reference", "work")
ENGINES = ("encoder", "decoder")


@dataclasses.dataclass
class Cell:
    name: str
    chips: int
    config: dict
    mix: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def _applies(metric: dict, workload: str) -> bool:
    return "workloads" not in metric or workload in metric["workloads"]


def check_config(config: dict, path: str) -> None:
    """Refuse a configuration that leaves out a key of REQUIRED (or one of
    its two engines), naming the key: there is no default codec."""
    for key in REQUIRED:
        if key not in config:
            raise ValueError(f"{path}: the configuration gives no {key!r} "
                             f"(every configuration gives {list(REQUIRED)})")
    for side in ENGINES:
        if side not in config["engines"]:
            raise ValueError(f"{path}: the configuration's 'engines' gives "
                             f"no {side!r} (\"<module>:<class>\")")


def named(path: str):
    """The class (or function) that "<module>:<name>" names."""
    module, _, name = path.partition(":")
    if not name:
        raise ValueError(f"{path!r} is not \"<module>:<name>\"")
    return getattr(importlib.import_module(module), name)


def engine(cfg: dict, side: str, rate: int, device, engine_kwargs=None):
    """The configuration's `side` ("encoder" or "decoder") engine at
    `rate` Hz: its class (`engines`) called as (rate, model_dir, device=,
    mode=, **engine_kwargs), the decoder's with emit_dtype="int16" too."""
    kw = {"mode": cfg["mode"], **(engine_kwargs or {})}
    if side == "decoder":
        kw["emit_dtype"] = "int16"
    return named(cfg["engines"][side])(rate, cfg["model_dir"], device=device,
                                       **kw)


def load(root: str, workload: str) -> Cell:
    with open(os.path.join(root, "BENCHMARK.json")) as f:
        bench = json.load(f)
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json; "
                       f"cells: {sorted(cells)}")
    cell = cells[workload]
    (entry,) = [c for c in bench["configs"] if c["name"] == cell["config"]]
    with open(os.path.join(root, entry["file"])) as f:
        config = json.load(f)
    check_config(config, entry["file"])
    # The configuration's model directory: its fixture, the model files.
    config["model_dir"] = os.path.join(root, config["fixture"])
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(
        name=workload, chips=int(cell["chips"]), config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])
