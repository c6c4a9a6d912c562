"""Residual vector quantizer — batched PyTorch port of lyra_tpu/models/rvq.py.

The 46 stage codebooks (16 codewords × 64 dims, 4 bits per stage) are read
from the quantizer's encode graph, as in the JAX package.  Encode masks
stages ≥ num_quantizers to −1 (the wire convention for unused stages).

Methods:
  "exact"   squared-difference distances, the TFLite encode graph's math;
  "fast"    ‖c‖² − 2·r·c scores (the JAX serving path's math);
  "kernel"  the same search as "fast" through kernel K2
            (ops/rvq_kernel.py): the CUDA kernel for CUDA features, its
            plain version for CPU features.
"""

from __future__ import annotations

import os

import numpy as np
import torch

from lyra_tpu_torch import config
from lyra_tpu_torch.ops import rvq_kernel
from lyra_tpu_torch.tflite import model as tfl
from lyra_tpu_torch.utils.device import resolve


def extract_codebooks(quantizer_path: str) -> np.ndarray:
    """[num_stages, 16, 64] float32 codebooks, in the encode graph's stage
    order (stage 0 = coarsest, carried in the packet MSBs)."""
    mdef = tfl.load(quantizer_path)
    encode_sg = mdef.subgraphs[mdef.signatures["encode"]["subgraph"]]
    cbs = [np.asarray(encode_sg.tensors[op.inputs[1]].data, np.float32)
           .reshape(16, config.NUM_FEATURES)
           for op in encode_sg.ops if op.name == "SQUARED_DIFFERENCE"]
    if len(cbs) != config.MAX_NUM_QUANTIZERS:
        raise ValueError(
            f"expected {config.MAX_NUM_QUANTIZERS} stages, got {len(cbs)}")
    return np.stack(cbs)


class ResidualVectorQuantizer:
    """Batched RVQ over `[num_streams, 64]` feature frames on `device`."""

    def __init__(self, codebooks: np.ndarray, device=None):
        self.device = resolve(device)
        self.codebooks = torch.tensor(np.asarray(codebooks, np.float32),
                                      device=self.device)  # [S, 16, F]
        self.c2 = (self.codebooks * self.codebooks).sum(-1).contiguous()
        # The bf16 engines' decode codebooks, rounded to bf16, as float32:
        # built here, so that no step (nor a CUDA-graph capture) allocates.
        self._rounded = {torch.bfloat16: self.codebooks.to(torch.bfloat16)
                         .float()}
        self.num_stages = codebooks.shape[0]
        self.num_codes = codebooks.shape[1]
        self.bits_per_stage = int(np.log2(codebooks.shape[1]))

    @classmethod
    def from_model_path(cls, model_path: str,
                        device=None) -> "ResidualVectorQuantizer":
        return cls(extract_codebooks(
            os.path.join(model_path, "quantizer.tflite")), device=device)

    def quantize(self, features: torch.Tensor, num_quantizers,
                 method: str = "kernel", max_stages: int | None = None
                 ) -> torch.Tensor:
        """features [B, F] → int32 stage indices [B, S] (−1 beyond
        num_quantizers: an int, or a [B] int tensor on the features'
        device, which is what a CUDA-graph capture takes — the int is a
        fill, the tensor is read where it lies, so neither copies from the
        host).  `max_stages` caps the recursion itself; computed stages
        equal the full run's."""
        run_stages = self.num_stages if max_stages is None else int(max_stages)
        if not 1 <= run_stages <= self.num_stages:
            raise ValueError(f"max_stages {max_stages} out of range")
        cbs = self.codebooks
        features = features.float()
        if method == "kernel":
            indices = rvq_kernel.rvq_encode(features.contiguous(), cbs,
                                            self.c2, run_stages)
        elif method == "fast":
            indices = rvq_kernel.rvq_encode_plain(features, cbs, self.c2,
                                                  run_stages)
        elif method == "exact":
            residual = features
            cols = []
            for s in range(run_stages):
                d = torch.sum(torch.square(residual[:, None, :] - cbs[s][None]),
                              dim=-1)
                idx = torch.argmin(d, dim=-1)
                residual = residual - cbs[s][idx]
                cols.append(idx.to(torch.int32))
            indices = torch.stack(cols, dim=1)
        else:
            raise ValueError(f"unknown quantize method {method!r}")
        b = features.shape[0]
        if run_stages < self.num_stages:
            pad = torch.full((b, self.num_stages - run_stages), -1,
                             dtype=torch.int32, device=indices.device)
            indices = torch.cat([indices, pad], dim=1)
        if isinstance(num_quantizers, torch.Tensor):
            if num_quantizers.device != indices.device:
                raise ValueError(f"num_quantizers on {num_quantizers.device}, "
                                 f"features on {indices.device}")
            nq = num_quantizers.to(torch.int32)
        else:
            nq = torch.full((b,), int(num_quantizers), dtype=torch.int32,
                            device=indices.device)
        nq = torch.clamp(nq, max=run_stages).expand(b)
        stage_ids = torch.arange(self.num_stages, dtype=torch.int32,
                                 device=indices.device)[None, :]
        return torch.where(stage_ids < nq[:, None], indices,
                           torch.full_like(indices, -1))

    def decode(self, indices: torch.Tensor, dtype: torch.dtype | None = None,
               max_stages: int | None = None) -> torch.Tensor:
        """stage indices [B, S] (−1 or out of range = unused) → features
        [B, F], as a gather-sum over the stages.

        dtype=torch.bfloat16 gathers bf16-rounded codewords and sums them
        in float32: the JAX package's one-hot bf16 matmul with float32
        accumulation (the bf16 engines' decode).  Features are float32
        either way."""
        s = self.num_stages
        if max_stages is not None:
            s = int(max_stages)
            if not 1 <= s <= self.num_stages:
                raise ValueError(f"max_stages {max_stages} out of range")
        idx = indices[:, :s].long()
        used = (idx >= 0) & (idx < self.num_codes)
        stage = torch.arange(s, device=idx.device)[None, :]
        cbs = self.codebooks
        if dtype is not None and dtype != torch.float32:
            if dtype not in self._rounded:
                raise ValueError(f"decode dtype {dtype} is not supported")
            cbs = self._rounded[dtype]
        rows = cbs[stage, idx.clamp(0, self.num_codes - 1)]
        return (rows * used[..., None]).sum(dim=1)

    def num_bits_to_stages(self, num_bits: int) -> int:
        if num_bits % self.bits_per_stage != 0:
            raise ValueError(
                f"num_bits {num_bits} not divisible by {self.bits_per_stage}")
        return num_bits // self.bits_per_stage
