"""lyra_tpu_torch — the PyTorch/CUDA port of the lyra_tpu lockstep codec tick.

The JAX package `lyra_tpu` is the reference this port is held against.  The
port imports nothing of it and never `jax`: what it needs of the JAX
package's framework-free modules (codec constants, the TFLite flatbuffer
parser) it keeps as its own copies (`config.py`, `tflite/model.py`,
`tflite/flatbuffer.py`), under the same names.

Entry points run on the card (`torch.device("cuda")`) unless `device=`
names another; without a card that default raises (utils/device.py).  On a
CUDA device the conv-stack core (ops/conv_stack.py) and the RVQ encode
search (ops/rvq_kernel.py) run as hand-written Hopper kernels built from
ops/csrc/ on first use; on a CPU tensor the same wrappers run their plain
PyTorch versions.
"""

__version__ = "0.1.0"
