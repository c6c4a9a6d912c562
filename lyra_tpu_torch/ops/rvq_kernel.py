"""RVQ encode kernel K2: the residual codebook search, one warp per stream.

Replaces `lyra_tpu/ops/rvq_kernel.py::RvqEncodeKernel` (the
`pl.pallas_call` at rvq_kernel.py:65).  The CUDA source is
ops/csrc/rvq_encode.cu; see there for what bounds it on the card and the
lane map (lane 2k + h: codeword k, feature half h).

`rvq_encode(features [B, F], codebooks [S, 16, F], c2 [S, 16], run_stages)`
returns `[B, run_stages]` int32 stage indices.  A CUDA tensor launches the
kernel (and counts the launch); a CPU tensor runs the plain version, which
is `quantize(method="fast")`'s search: argmin ‖c‖² − 2·r·c per stage, lowest
index on ties, then subtract the chosen codeword.

`rvq_plan` is the launcher's grid rule (`lyra_rvq_plan` in the .cu; change
both together, tests/test_torch_cuda.py holds them equal).
"""

from __future__ import annotations

import ctypes
import functools
from typing import NamedTuple

import torch

from lyra_tpu_torch.ops import cuda_build

RVQ = cuda_build.KernelCounter(
    "rvq_encode", "lyra_tpu_torch/ops/csrc/rvq_encode.cu",
    "lyra_tpu/ops/rvq_kernel.py:65")
KERNELS = (RVQ,)
_FEATURES, _CODES = 64, 16  # compiled into rvq_encode.cu
RVQ_MAX_WARPS = 16  # kMaxWarps: warps (streams in flight) per block
# kStageBytes: a stage's codewords and ||c||² in shared memory, + its mbarrier
RVQ_STAGE_BYTES = (_CODES * _FEATURES + _CODES) * 4 + 8


class RvqPlan(NamedTuple):
    warps: int  # per block; warp w of block g takes streams g·W + w + j·G·W
    blocks: int
    smem: int  # dynamic shared bytes per block


def rvq_plan(batch: int, run_stages: int, sms: int) -> RvqPlan:
    """W = ceil(B / SMs) warps per block, at most RVQ_MAX_WARPS, and
    min(ceil(B / W), SMs) blocks, so every SM works once B ≥ SMs and a
    larger batch loops inside the warps."""
    warps = min(RVQ_MAX_WARPS, max(1, -(-batch // sms)))
    return RvqPlan(warps, min(-(-batch // warps), sms),
                   run_stages * RVQ_STAGE_BYTES)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("rvq_encode.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    lib.lyra_rvq_encode.argtypes = [p, p, p, p, i, i, p]
    lib.lyra_rvq_encode.restype = ctypes.c_int
    lib.lyra_rvq_plan.argtypes = [i, i, i, ctypes.POINTER(i)]
    lib.lyra_rvq_plan.restype = None
    return lib


def rvq_encode_plain(features: torch.Tensor, codebooks: torch.Tensor,
                     c2: torch.Tensor, run_stages: int) -> torch.Tensor:
    residual = features.float()
    cols = []
    for s in range(run_stages):
        scores = c2[s][None, :] - 2.0 * (residual @ codebooks[s].t())
        idx = torch.argmin(scores, dim=-1)
        residual = residual - codebooks[s][idx]
        cols.append(idx.to(torch.int32))
    return torch.stack(cols, dim=1)


def rvq_encode(features: torch.Tensor, codebooks: torch.Tensor,
               c2: torch.Tensor, run_stages: int) -> torch.Tensor:
    if not 1 <= run_stages <= codebooks.shape[0]:
        raise ValueError(f"run_stages {run_stages} out of range")
    if features.device.type == "cpu":
        return rvq_encode_plain(features, codebooks, c2, run_stages)
    if not features.is_cuda:
        raise NotImplementedError(f"no RVQ kernel for {features.device}")
    b = features.shape[0]
    if (features.shape[1:] != (_FEATURES,)
            or codebooks.shape[1:] != (_CODES, _FEATURES)
            or c2.shape != codebooks.shape[:2]):
        raise ValueError(
            f"RVQ kernel takes [B, {_FEATURES}] features and "
            f"[S, {_CODES}, {_FEATURES}] codebooks, got "
            f"{tuple(features.shape)} / {tuple(codebooks.shape)}")
    for t in (features, codebooks, c2):
        if (t.device != features.device or t.dtype != torch.float32
                or not t.is_contiguous()):
            raise ValueError("RVQ kernel takes contiguous float32 tensors "
                             "on one device")
    if codebooks.data_ptr() % 16 or c2.data_ptr() % 16:
        raise ValueError("RVQ kernel copies the codebooks and c2 in 16-byte "
                         "chunks: their data must be 16-byte aligned")
    out = torch.empty((b, run_stages), device=features.device,
                      dtype=torch.int32)
    err = _lib().lyra_rvq_encode(
        features.data_ptr(), codebooks.data_ptr(), c2.data_ptr(),
        out.data_ptr(), b, run_stages,
        cuda_build.stream_handle(features.device))
    cuda_build.check(err, RVQ.name)
    RVQ.launches += 1
    return out
