"""lyra_tpu_torch — the PyTorch/CUDA port of the lyra_tpu lockstep codec tick.

The JAX package `lyra_tpu` is the reference this port is held against.  The
port imports only the framework-free parts of it (codec constants, the
TFLite flatbuffer parser and the host packet codecs) and never `jax`.

On a CUDA device the conv-stack core (ops/conv_stack.py) and the RVQ
encode search (ops/rvq_kernel.py) run as hand-written Hopper kernels built
from ops/csrc/ on first use; on a CPU tensor the same wrappers run their
plain PyTorch versions.

Importing `lyra_tpu` runs its package __init__, which imports jax when
LYRA_TPU_PLATFORM is set; unset it in environments without jax.
"""

__version__ = "0.1.0"
