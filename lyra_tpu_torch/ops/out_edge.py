"""LyraGAN's audio output edge as one kernel: its last transpose conv and
the overlap-add tail after it.

The graph's edge (ops/fused_stack.py matches it) is a TRANSPOSE_CONV from
`[T, C]` to `[N, 1]` (kernel K, stride S, a bias), the READ_VARIABLE of an
L-sample state, the ADD of the state to the conv's first L samples, the
ASSIGN_VARIABLE of its last L samples, and the CONCATENATION of the head
with samples L .. N − L as the hop's PCM.  `out_edge(x, w, bias, stride,
rows, state)` computes all of it:

    x [B, T, C], w [K, C], bias [1], state [B, L]
    → (pcm [B, rows − L] float32, new state [B, L] in x's dtype)

and without a state the transpose conv alone, `[B, rows, 1]` in x's dtype
(FusedStack.unfused).  float32 and bfloat16, chosen by the operands' dtype;
in bf16 the conv's result (bias included) is rounded once and the head's
ADD is the graph's bf16 add.  A CUDA tensor launches gan_out_edge or
gan_out_edge_bf16 (ops/csrc/out_edge.cu, which says what bounds it and
what its design does about that) and counts the launch, and a call with a
state also counts its rows as the tracer's `gan.edge_rows`; a CPU tensor
runs the plain version, the executor's ops in the graph's order
(tflite/executor.py).  Anything else raises.

The kernels replace no Pallas kernel: the JAX package runs this edge as
XLA ops outside its megakernel.  `supported` is the launchers' rule of
what their instances cover (`lyra_gan_out_edge_supported` in the .cu;
change both together, tests/test_torch_cuda.py holds them equal).
"""

from __future__ import annotations

import ctypes
import functools
from typing import Optional

import torch

from lyra_tpu_torch.ops import cuda_build
from lyra_tpu_torch.tflite import executor
from lyra_tpu_torch.utils import trace

_SOURCE = "lyra_tpu_torch/ops/csrc/out_edge.cu"
_REPLACES = "none: lyra_tpu/ops/fused_stack.py runs the edges as XLA ops"
OUT_EDGE = cuda_build.KernelCounter("gan_out_edge", _SOURCE, _REPLACES)
OUT_EDGE_BF16 = cuda_build.KernelCounter("gan_out_edge_bf16", _SOURCE,
                                         _REPLACES)
KERNELS = (OUT_EDGE, OUT_EDGE_BF16)
BY_DTYPE = {torch.float32: OUT_EDGE, torch.bfloat16: OUT_EDGE_BF16}

# out_edge.cu's instances and limits (kStride, kTaps, kMaxT, kMaxChannels).
STRIDE, TAPS, MAX_T, MAX_CHANNELS = 4, 13, 80, 64


def supported(t_in: int, channels: int, k: int, stride: int, rows: int,
              state_rows: int) -> bool:
    """Whether the kernels take a transpose conv from [t_in, channels] to
    [rows, 1] with k taps at `stride` and an overlap of state_rows (0: the
    conv alone)."""
    return (stride == STRIDE and 1 <= k <= STRIDE * TAPS
            and 16 <= t_in <= MAX_T and t_in % 16 == 0
            and 8 <= channels <= MAX_CHANNELS
            and channels & (channels - 1) == 0
            and 4 <= rows <= (t_in - 1) * stride + k and rows % 4 == 0
            and state_rows >= 0 and state_rows % 8 == 0
            and 2 * state_rows < rows)


@functools.lru_cache(maxsize=None)
def _lib() -> ctypes.CDLL:
    lib = cuda_build.load("out_edge.cu")
    p, i = ctypes.c_void_p, ctypes.c_int
    for counter in KERNELS:
        fn = getattr(lib, f"lyra_{counter.name}")
        fn.argtypes = [p] * 7 + [i] * 7 + [p]
        fn.restype = ctypes.c_int
    lib.lyra_gan_out_edge_supported.argtypes = [i] * 6
    lib.lyra_gan_out_edge_supported.restype = ctypes.c_int
    return lib


def out_edge_plain(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
                   stride: int, rows: int,
                   state: Optional[torch.Tensor] = None):
    """The executor's ops in x's dtype: TRANSPOSE_CONV, then with a state
    the STRIDED_SLICEs, the ADD, the CONCATENATION and the PCM as float32."""
    b, t_in, c = x.shape
    w_t = w.t().reshape(c, 1, w.shape[0], 1).contiguous()  # [I, O, K, 1]
    y = executor.transpose_conv(x.unsqueeze(2), w_t, bias, (stride, 1),
                                (rows, 1)).squeeze(2)  # [B, rows, 1]
    if state is None:
        return y
    n = state.shape[1]
    head = y[:, :n, 0] + state
    pcm = torch.cat([head, y[:, n:rows - n, 0]], dim=1)
    return pcm.float(), y[:, rows - n:, 0].contiguous()


def out_edge(x: torch.Tensor, w: torch.Tensor, bias: torch.Tensor,
             stride: int, rows: int, state: Optional[torch.Tensor] = None):
    """The edge on x [B, T, C] (see the module docstring): the kernel on
    CUDA tensors, the plain version on CPU tensors."""
    if x.device.type == "cpu":
        return out_edge_plain(x, w, bias, stride, rows, state)
    if not x.is_cuda:
        raise NotImplementedError(f"no output-edge kernel for {x.device}")
    if x.dtype not in BY_DTYPE:
        raise ValueError(f"the output-edge kernels take float32 or bfloat16, "
                         f"got {x.dtype}")
    for t in (x, w, bias, state):
        if t is None:
            continue
        if t.device != x.device or t.dtype != x.dtype:
            raise ValueError(
                f"the output-edge kernels take operands of one dtype on one "
                f"device: {x.dtype} on {x.device}, got {t.dtype} on "
                f"{t.device}")
        if not t.is_contiguous():
            raise ValueError("the output-edge kernels take contiguous "
                             "tensors")
    if any(t is not None and t.data_ptr() % 16 for t in (x, w, state)):
        raise ValueError("the output-edge kernels read x, w and the state "
                         "16 bytes at a time: they take them 16-byte "
                         "aligned")
    b, t_in, c = x.shape
    k = w.shape[0]
    n = 0 if state is None else state.shape[1]
    if (w.shape != (k, c) or bias.numel() != 1
            or not supported(t_in, c, k, stride, rows, n)
            or (state is not None and state.shape != (b, n))):
        raise ValueError(
            f"output edge x {tuple(x.shape)} w {tuple(w.shape)} stride "
            f"{stride} rows {rows} state "
            f"{None if state is None else tuple(state.shape)}")
    pcm = new_state = y = None
    if state is None:
        y = torch.empty((b, rows, 1), device=x.device, dtype=x.dtype)
    else:
        pcm = torch.empty((b, rows - n), device=x.device, dtype=torch.float32)
        new_state = torch.empty((b, n), device=x.device, dtype=x.dtype)
    counter = BY_DTYPE[x.dtype]
    ptr = [None if t is None else t.data_ptr()
           for t in (x, w, bias, state, pcm, new_state, y)]
    err = getattr(_lib(), f"lyra_{counter.name}")(
        *ptr, b, t_in, c, k, stride, rows, n,
        cuda_build.stream_handle(x.device))
    cuda_build.check(err, counter.name)
    counter.launches += 1
    if state is None:
        return y
    trace.count("gan.edge_rows", b)
    return pcm, new_state
