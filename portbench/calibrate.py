"""python3 -m portbench.calibrate --workload <cell> --seeds 1,2,3 [--control]
                                [--seconds S]

The readings the comparison's limits are set from (PERF.md gives them):
runs the cell once per seed in this one process, at the cell's own size
and window, and prints each run's comparison numbers as one JSON line.
With --control the program runs its own path one precision below the
configuration's, as the configuration's `control` entry names it (the
plain lowering with TF32 on for float32; fp8 boundaries for bf16): a
control that the limits must fail.  Not part of a benchmark run.
"""

from __future__ import annotations

import argparse
import json
import sys

from portbench import harness, spec


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=None)
    p.add_argument("--control", action="store_true")
    args = p.parse_args(argv)
    with open("BENCHMARK.json") as f:
        seconds = args.seconds or json.load(f)["run_seconds"]
    control = spec.load(".", args.workload).config["control"]
    kw = ({"engine_kwargs": control["engine"], "tf32": control["tf32"]}
          if args.control else {})
    for seed in (int(s) for s in args.seeds.split(",")):
        result, notes = harness.run(args.workload, seed, seconds, False, **kw)
        line = {"workload": args.workload, "seed": seed,
                "control": args.control, "correct": result["correct"]}
        line.update({k: c["value"] for k, c in result["checks"].items()})
        line.update({k: m["value"] for k, m in result["metrics"].items()})
        line["notes"] = notes
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
