"""The port's TFLite probes (lyra_tpu_torch/tools/probe_int8_rounding.py,
probe_xnnpack_divergence.py) vs the JAX package's, where TensorFlow is
installed: on the small islands fixture (tests/golden/
synthetic_lyra_islands/small) the rounding probe prints the JAX probe's
table and returns its counts, and leaves the rounding table as it was."""

import os

import pytest
import torch

from lyra_tpu_torch.tflite import executor

SMALL = os.path.join(os.path.dirname(__file__), "golden",
                     "synthetic_lyra_islands", "small")


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    """torch on one intra-op thread for the module: tier-1 runs six test
    workers on the machine's cores, and these small ops gain nothing from
    more threads (measured: the same time alone) but lose several times
    over to the others' oversubscription."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def test_rounding_probe_prints_the_jax_table(capsys):
    pytest.importorskip("tensorflow")
    from lyra_tpu.tools import probe_int8_rounding as jax_probe
    from lyra_tpu_torch.tools import probe_int8_rounding

    before = dict(executor._INT8_ROUNDING)
    want = jax_probe.probe(SMALL, frames=1)
    want_out = capsys.readouterr().out
    got = probe_int8_rounding.probe(SMALL, frames=1)
    assert capsys.readouterr().out == want_out
    assert {k: dict(v) for k, v in got.items()} == {
        k: dict(v) for k, v in want.items()}
    assert executor._INT8_ROUNDING == before
    assert "LEAKY_RELU" in want_out and "TRANSPOSE_CONV" in want_out
