"""Device ms per tick of the conv-stack (K1) kernels: ops/csrc/conv_stack.cu
and ops/csrc/core_ops.cu, by their kernel names at d33c86f."""

from portbench.metrics._device import seconds_per_tick

K1_KERNELS = (
    "conv1d_fwd", "transpose_conv1d_fwd", "depthwise_conv1d_fwd",
    "conv1d_fwd_bf16", "transpose_conv1d_fwd_bf16",
    "depthwise_conv1d_fwd_bf16",
    "core_eltwise", "core_gather", "core_eltwise_bf16", "core_gather_bf16",
)


def read(ctx):
    s = seconds_per_tick(ctx, K1_KERNELS)
    return s * 1e3 if s > 0 else None
