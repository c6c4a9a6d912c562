"""The port runs without jax and without the JAX package.

The GPU machine has no jax, and the port keeps its own copies of what it
needs from the JAX package.  A subprocess installs a `sys.meta_path` finder
that raises on any import of jax, jaxlib or the top-level `lyra_tpu`
package (exactly that name: `lyra_tpu_torch` passes), imports every module
of lyra_tpu_torch, builds both engines on the CPU from the small synthetic
fixture and runs one tick: float at 16 kHz, then bf16 at 48 kHz (the
resampler and the bf16 paths).
"""

import os
import subprocess
import sys
import textwrap

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_CHILD = textwrap.dedent("""
    import importlib
    import importlib.abc
    import pkgutil
    import sys

    BLOCKED = ("jax", "jaxlib", "lyra_tpu")

    class NoJax(importlib.abc.MetaPathFinder):
        def find_spec(self, name, path=None, target=None):
            if name.split(".")[0] in BLOCKED:
                raise ImportError(f"blocked import: {name}")
            return None

    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    sys.meta_path.insert(0, NoJax())

    import numpy as np
    import torch

    import lyra_tpu_torch
    modules = [m.name for m in pkgutil.walk_packages(
        lyra_tpu_torch.__path__, "lyra_tpu_torch.")]
    for name in modules:
        importlib.import_module(name)
    assert len(modules) >= 25, modules
    from lyra_tpu_torch import packet
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.dsp.resampler import Resampler, StreamingResampler
    from lyra_tpu_torch.utils import state

    path = sys.argv[1]
    enc = EncoderEngine(16000, path, enable_dtx=True, device="cpu")
    dec = DecoderEngine(16000, path, device="cpu")
    es, ds = enc.init_state(2), dec.init_state(2)
    audio = torch.from_numpy(
        np.random.default_rng(0).normal(0, 3000, (2, 320)).astype(np.float32))
    idx, _, es = enc.step(es, audio, 16)
    wire = packet.pack_wire_device(idx, 64)
    back = torch.full((2, 46), -1, dtype=torch.int32)
    back[:, :16] = packet.unpack_wire_device(wire, 64)
    out, cn, ds = dec.step(ds, back, torch.tensor([True, False]))
    assert out.shape == (2, 320) and bool(torch.isfinite(out).all())
    state.state_to_numpy(ds)

    enc = EncoderEngine(48000, path, mode="bf16", device="cpu")
    dec = DecoderEngine(48000, path, mode="bf16", device="cpu")
    es, ds = enc.init_state(2), dec.init_state(2)
    audio = torch.from_numpy(
        np.random.default_rng(1).normal(0, 3000, (2, 960)).astype(np.float32))
    idx, _, es = enc.step(es, audio, 16)
    out, cn, ds = dec.step(ds, idx, torch.tensor([True, True]))
    assert out.shape == (2, 960) and bool(torch.isfinite(out).all())
    assert ds["gan"][next(iter(ds["gan"]))].dtype == torch.bfloat16
    assert ds["resampler"].shape == (2, 34)
    state.state_from_numpy(state.state_to_numpy(es), "cpu")  # bf16 leaves
    y, _ = Resampler(16000, 8000, device="cpu").resample(
        torch.zeros(1, 34), torch.ones(1, 320))
    assert y.shape == (1, 160)
    assert StreamingResampler(8000, 16000).resample(
        np.zeros(160, np.int16)).shape == (320,)
    assert not any(m.split(".")[0] in BLOCKED for m in sys.modules)
    print("NO_JAX_TICK_OK")
""")


def test_port_imports_and_ticks_without_jax():
    env = {k: v for k, v in os.environ.items() if k != "LYRA_TPU_PLATFORM"}
    env["PYTHONPATH"] = os.pathsep.join(
        p for p in (REPO, env.get("PYTHONPATH")) if p)
    small = os.path.join(REPO, "tests", "golden", "synthetic_lyra", "small")
    proc = subprocess.run([sys.executable, "-c", _CHILD, small], env=env,
                          cwd=REPO, capture_output=True, text=True,
                          timeout=120)
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert "NO_JAX_TICK_OK" in proc.stdout
