"""Finding a cell's pieces by name.

BENCHMARK.json (at the checkout's root) names the cell: its configuration
(whose entry gives the file of sizes) and its traffic mix
(portbench/traffic/<traffic>.json).  Its metrics are the end-to-end and
per-layer entries whose `workloads` list the cell, or that have no such
list; a per-layer metric's reader is portbench/metrics/<name>.py.  A new
cell, configuration, mix or metric is new files and new entries: nothing
here changes.
"""

from __future__ import annotations

import dataclasses
import json
import os
from typing import List


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
    # The configuration's model directory (its three .tflite graphs).
    config["model_dir"] = os.path.join(root, config["fixture"])
    with open(os.path.join(root, "portbench", "traffic",
                           cell["traffic"] + ".json")) as f:
        mix = json.load(f)
    return Cell(
        name=workload, chips=int(cell["chips"]), config=config, mix=mix,
        end_to_end=[m for m in bench["end_to_end"] if _applies(m, workload)],
        per_layer=[m for m in bench["per_layer"] if _applies(m, workload)])
