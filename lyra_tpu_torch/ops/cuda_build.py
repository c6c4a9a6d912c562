"""Build the hand-written CUDA kernels in ops/csrc/ and bind them with ctypes.

Each source file is compiled by `nvcc` into its own shared library with a
plain C interface (no PyTorch headers, so a build takes seconds), under
`lyra_tpu_torch/_build/`, on first use.  The library name carries a hash of
the source, so an edited source rebuilds and a stale library is never
loaded.  A missing `nvcc` or a failed build raises: there is no fallback.

Wrappers pass `tensor.data_ptr()` and the current stream's handle as
`c_void_p`; every exported launcher returns the `cudaError_t` of
`cudaGetLastError()` after its launch, and `check()` raises on a nonzero
code.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess

CSRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "csrc")
BUILD_DIR = os.path.join(os.path.dirname(CSRC), "..", "_build")
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def build(source: str) -> str:
    """Compile csrc/`source` (if its hash is new) → path of the .so."""
    src = os.path.join(CSRC, source)
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    os.makedirs(BUILD_DIR, exist_ok=True)
    stem = os.path.splitext(source)[0]
    lib = os.path.abspath(os.path.join(BUILD_DIR, f"lib{stem}-{digest}.so"))
    if os.path.exists(lib):
        return lib
    tmp = f"{lib}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, src],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc failed on {source}:\n{proc.stderr}")
    with open(os.path.join(BUILD_DIR, f"{stem}.ptxas.txt"), "w") as f:
        f.write(proc.stderr)  # register / shared-memory / spill report
    os.replace(tmp, lib)
    return lib


@functools.lru_cache(maxsize=None)
def load(source: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library; cached per process."""
    return ctypes.CDLL(build(source))


def check(err: int, kernel: str) -> None:
    if err != 0:
        raise RuntimeError(f"CUDA launch of {kernel} failed: cudaError {err}")


def stream_handle(device) -> ctypes.c_void_p:
    import torch

    return ctypes.c_void_p(torch.cuda.current_stream(device).cuda_stream)


class KernelCounter:
    """Launch count of one kernel.  A wrapper adds one where it launches
    the kernel and nowhere else, so a run can show its path went through
    the kernel (chip_smoke.py resets and reads these)."""

    def __init__(self, name: str, source: str, replaces: str):
        self.name = name
        self.source = source
        self.replaces = replaces
        self.launches = 0
