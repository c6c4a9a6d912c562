"""The benchmark of lyra_tpu_torch: the pipelined server tick at capacity
on one NVIDIA H100.  See portbench/README.md."""
