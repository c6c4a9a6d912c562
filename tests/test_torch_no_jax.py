"""The port runs without jax and without the JAX package.

The GPU machine has no jax, and the port keeps its own copies of what it
needs from the JAX package.  A subprocess installs a `sys.meta_path` finder
that raises on any import of jax, jaxlib, ml_dtypes or the top-level
`lyra_tpu` package (exactly that name: `lyra_tpu_torch` passes), imports
every module of lyra_tpu_torch, builds both engines on the CPU from the
small synthetic fixture and runs one tick: float at 16 kHz, then on the
small islands fixture in int8, fakequant, with int8 state and with fp8
boundaries in bf16 (the plain backend), then bf16 at 48 kHz (the
resampler and the bf16 paths); then a server pair ticks on the
wire, snapshots a bf16 decoder and restores it bit for bit; then the
port's serve_main serves a decode run over the native ingest and egress
(transport, control plane, stats sink and the bridge's modules among the
imports) and echoes PCM for the datagrams it is sent; last, one hop goes
through the single-stream facades (LyraEncoder → LyraDecoder) and a wav
through the encoder and decoder CLIs; last, the multi-device dry run on a
CPU mesh of two shards (parallel/dryrun.py: a sharded codec tick and a
sharded bridge tick).
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

    BLOCKED = ("jax", "jaxlib", "ml_dtypes", "lyra_tpu")

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
    assert len(modules) >= 65, modules
    assert {f"lyra_tpu_torch.{m}" for m in (
        "utils.native", "tools.jitter_buffer", "tools.udp_ingest",
        "tools.udp_egress", "tools.control_auth", "tools.fleet",
        "tools.conference", "tools.serve_main", "dsp.utils", "utils.wav",
        "dsp.buffered_resampler", "codec.preprocessor", "codec.encoder",
        "codec.decoder", "codec", "testing.fakes", "testing",
        "tools.packet_loss", "tools.cli_lib", "tools.encoder_main",
        "tools.decoder_main", "tools.batch_transcode", "tools.benchmark",
        "tools.melspec_benchmark", "tools.fleet_main", "client",
        "examples", "examples.drain_migrate", "examples.loopback_call",
        "examples.udp_call", "examples.conference_call",
        "examples.rate_adapt_call", "examples.multihost_migrate",
        "parallel", "parallel.sharding", "parallel.dryrun",
        "tools.probe_int8_rounding", "tools.probe_xnnpack_divergence",
        "utils.trace")} <= set(modules)
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

    import os
    islands = os.path.join(os.path.dirname(os.path.dirname(path)),
                           "synthetic_lyra_islands", "small")
    for kw in ({"mode": "int8"}, {"mode": "fakequant"},
               {"state_compression": "int8"},
               {"boundary_store": "f8", "mode": "bf16"}):
        enc = EncoderEngine(16000, islands, backend="plain", device="cpu",
                            **kw)
        dec = DecoderEngine(16000, islands, backend="plain", device="cpu",
                            **kw)
        idx, _, _ = enc.step(enc.init_state(2), audio, 16)
        out, _, ds = dec.step(dec.init_state(2), idx,
                              torch.tensor([True, True]))
        assert bool(torch.isfinite(out).all()), kw
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

    import os, tempfile
    from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer
    enc = EncoderServer(2, engine=EncoderEngine(16000, path, device="cpu"),
                        bitrate=6000)
    dec = DecoderServer(2, engine=DecoderEngine(16000, path, mode="bf16",
                                                device="cpu"))
    for srv in (enc, dec):
        srv.add_streams(["a", "b"])
    hop = np.random.default_rng(2).normal(0, 3000, (2, 320)).astype(np.int16)
    wire, sizes = enc.tick_wire(hop)
    assert wire.shape == (2, 15) and list(sizes) == [15, 15]
    assert dec.tick_wire(wire, sizes > 0, sizes).dtype == np.int16
    with tempfile.TemporaryDirectory() as tmp:
        dec.save(os.path.join(tmp, "dec"))
        back = DecoderServer(2, engine=dec.engine)
        back.restore(os.path.join(tmp, "dec"))
    for k, v in dec._state["gan"].items():
        assert torch.equal(back._state["gan"][k].view(torch.int16),
                           v.view(torch.int16)), k

    import socket, threading, time
    from lyra_tpu_torch.tools import serve_main
    from lyra_tpu_torch.utils import native
    assert native.load() is not None
    echo = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    echo.bind(("127.0.0.1", 0))
    echo.settimeout(0.05)
    box, ready, stop = {}, threading.Event(), threading.Event()
    th = threading.Thread(target=serve_main.main, kwargs=dict(
        argv=["--capacity", "2", "--seconds", "0", "--model_path", path,
              "--playout_delay", "1", "--report_every", "30",
              "--echo", f"127.0.0.1:{echo.getsockname()[1]}"],
        _on_ready=lambda port: (box.update(port=port), ready.set()),
        _stop=stop, device="cpu"))
    th.start()
    assert ready.wait(60)
    tx = socket.socket(socket.AF_INET, socket.SOCK_DGRAM)
    got, seq, deadline = [], 0, time.time() + 60
    while len(got) < 4 and time.time() < deadline:
        for slot in range(2):
            tx.sendto(slot.to_bytes(2, "big") + seq.to_bytes(4, "big")
                      + bytes(8), ("127.0.0.1", box["port"]))
        seq += 1
        try:
            got.append(echo.recvfrom(4096)[0])
        except socket.timeout:
            pass
    stop.set()
    th.join(60)
    assert not th.is_alive() and len(got) == 4
    assert all(len(d) == 6 + 640 for d in got)

    from lyra_tpu_torch.codec import LyraDecoder, LyraEncoder
    from lyra_tpu_torch.tools import decoder_main, encoder_main
    from lyra_tpu_torch.utils import wav
    speech = np.random.default_rng(3).normal(0, 3000, 5 * 320).astype(np.int16)
    pkt = LyraEncoder(16000, 1, 6000, model_path=path,
                      device="cpu").encode(speech[:320])
    dec = LyraDecoder(16000, 1, path, device="cpu")
    assert len(pkt) == 15 and dec.set_encoded_packet(pkt)
    assert dec.decode_samples(320).shape == (320,)
    with tempfile.TemporaryDirectory() as tmp:
        wav.write_wav_int16(os.path.join(tmp, "s.wav"), speech, 16000)
        assert encoder_main.main([f"--input_path={tmp}/s.wav",
                                  f"--output_dir={tmp}",
                                  f"--model_path={path}"], device="cpu") == 0
        assert os.path.getsize(os.path.join(tmp, "s.lyra")) == 5 * 8
        assert decoder_main.main([f"--encoded_path={tmp}/s.lyra",
                                  f"--output_dir={tmp}",
                                  f"--model_path={path}"], device="cpu") == 0
        assert len(wav.read_wav_int16(
            os.path.join(tmp, "s_decoded.wav")).samples) == 5 * 320
    from lyra_tpu_torch.parallel.dryrun import dryrun_multichip
    dryrun_multichip(2, devices=["cpu"] * 2, model_path=path)
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
