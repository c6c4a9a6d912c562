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


# glibc's mallopt parameters: blocks up to 32 MiB come from the heap, and
# a freed block stays there.
M_TRIM_THRESHOLD, M_MMAP_THRESHOLD = -1, -3
MMAP_THRESHOLD = 32 << 20  # glibc's largest
TRIM_THRESHOLD = 1 << 30


def forbidden_loaded() -> list:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def keep_heap() -> bool:
    """Serve each tick's host arrays (a fleet's PCM is 9 MB a tick each
    way) from pages the process already has, as a long-running server's
    grown heap does: glibc otherwise maps a block of this size afresh at
    each allocation and returns it at the free, and a young process pays
    a page fault on every page of every tick's arrays (the first minute
    of a fleet's run twice as slow as later).  → whether the C library
    took the settings."""
    import ctypes

    try:
        mallopt = ctypes.CDLL(None).mallopt
    except (AttributeError, OSError):
        return False
    return bool(mallopt(M_MMAP_THRESHOLD, MMAP_THRESHOLD)) and \
        bool(mallopt(M_TRIM_THRESHOLD, TRIM_THRESHOLD))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="python3 -m portbench")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)
    heap_kept = keep_heap()

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
    notes.append(f"host heap kept (glibc mallopt): {heap_kept}")
    for line in notes:
        print(line, file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
