"""python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Runs one cell of BENCHMARK.json once, from the root of a checkout, on the
card this process sees, and prints the result as one JSON line, last on
standard output; each number the comparison judged, beside its limit, is
last on standard error.  Without a CUDA device, or with fewer than the
cell asks for, it prints no result and exits with 2; if JAX or the JAX
package was loaded into this process, with 3.
"""

from __future__ import annotations

import time

_START = time.perf_counter()  # set-up counts from the process's start

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402

# Top-level module names the run must not load (compared whole:
# lyra_tpu_torch is not lyra_tpu).
FORBIDDEN = ("jax", "jaxlib", "flax", "lyra_tpu")


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from portbench import spec

    cell = spec.load(".", args.workload)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f"portbench: {args.workload} needs {cell.chips} CUDA "
              f"device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from portbench import harness

    result, notes = harness.run(args.workload, args.seed, args.seconds,
                                bool(args.trace), setup_start=_START)
    found = forbidden_loaded()
    if found:
        print(f"portbench: the run loaded {', '.join(found)}; no result",
              file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
