"""The port's offline tools vs the JAX package's, on the small synthetic
fixture from numpy-seeded inputs, on the CPU.

  * packet-loss models: the same received/lost sequences for one seed;
  * wav files written by either package read back equal by the other;
  * encoder_main / decoder_main vs the JAX CLIs on one wav: `.lyra` bytes
    identical, decoded wav within 1 int16 LSB (the facades' bar), the same
    exit codes on an invalid wav, an empty stream and a missing model;
  * batch_transcode: each row of encode_batch byte-identical to the
    single-stream encoder, decode_batch within 1 LSB of the single-stream
    decoder (the JAX test's bar: the engine's crossfade is float32, the
    facade's float64), inputs with the same stem not clobbered;
  * run_benchmark's rows, CSV, profiler trace and stage toggles, the
    toggles' garbage flag, fakequant on the plain backend; melspec_benchmark
    runs.
"""

import glob
import logging
import os

import numpy as np
import pytest

from lyra_tpu.tools import decoder_main as jax_decoder_main
from lyra_tpu.tools import encoder_main as jax_encoder_main
from lyra_tpu.tools import packet_loss as jax_packet_loss
from lyra_tpu.utils import wav as jax_wav
from lyra_tpu_torch import config
from lyra_tpu_torch.codec import LyraDecoder
from lyra_tpu_torch.tools import (
    batch_transcode,
    benchmark,
    cli_lib,
    decoder_main,
    encoder_main,
    melspec_benchmark,
    packet_loss,
)
from lyra_tpu_torch.utils import wav

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
CPU = {"device": "cpu"}


def _wave(seed, rate, samples):
    """Speech-level int16 noise with quiet stretches."""
    rng = np.random.default_rng(seed)
    gain = np.where((np.arange(samples) // (rate // 10)) % 3 == 2, 30.0,
                    4000.0)
    return (rng.normal(0.0, 1.0, samples) * gain).astype(np.int16)


def test_packet_loss_models_match_jax():
    for rate, burst in ((0.1, 2.0), (0.3, 4.0), (0.0, 1.0)):
        ours = packet_loss.GilbertModel.create(rate, burst)
        ref = jax_packet_loss.GilbertModel.create(rate, burst)
        assert [ours.is_packet_received() for _ in range(500)] == \
            [ref.is_packet_received() for _ in range(500)]
    for rate, burst in ((0.6, 1.0), (0.1, 0.5), (-0.1, 2.0)):
        assert packet_loss.GilbertModel.create(rate, burst) is None
        assert jax_packet_loss.GilbertModel.create(rate, burst) is None
    text = "0.5,1.5:0.2,0.25"
    pattern = packet_loss.PacketLossPattern.parse(text)
    assert str(pattern) == str(jax_packet_loss.PacketLossPattern.parse(text))
    for rate in (16000, 48000):
        hop = config.num_samples_per_hop(rate)
        ours = packet_loss.FixedPacketLossModel(rate, hop, pattern.starts,
                                                pattern.durations)
        ref = jax_packet_loss.FixedPacketLossModel(rate, hop, pattern.starts,
                                                   pattern.durations)
        assert [ours.is_packet_received() for _ in range(120)] == \
            [ref.is_packet_received() for _ in range(120)]
    with pytest.raises(ValueError):
        packet_loss.PacketLossPattern.parse("0.5,1.5:0.2")


def test_wav_round_trip_across_packages(tmp_path):
    samples = _wave(0, 48000, 4801)
    for write, read in ((wav.write_wav_int16, jax_wav.read_wav_int16),
                        (jax_wav.write_wav_int16, wav.read_wav_int16)):
        path = str(tmp_path / "x.wav")
        write(path, samples, 48000, 1)
        got = read(path)
        np.testing.assert_array_equal(got.samples, samples)
        assert (got.sample_rate_hz, got.num_channels) == (48000, 1)
    (tmp_path / "bad.wav").write_bytes(b"RIFF nonsense")
    with pytest.raises(ValueError):
        wav.read_wav_int16(str(tmp_path / "bad.wav"))


@pytest.mark.parametrize("rate", [16000, 48000])
def test_clis_match_jax(tmp_path, rate, caplog):
    caplog.set_level(logging.INFO, logger="lyra_tpu")
    hop = config.num_samples_per_hop(rate)
    src = tmp_path / "speech.wav"
    wav.write_wav_int16(str(src), _wave(1, rate, 30 * hop + 17), rate, 1)
    outs = {}
    for name, enc, dec, kw in (
            ("jax", jax_encoder_main.main, jax_decoder_main.main, {}),
            ("port", encoder_main.main, decoder_main.main, CPU)):
        out = tmp_path / name
        assert enc([f"--input_path={src}", f"--output_dir={out}",
                    "--bitrate=6000", f"--model_path={SMALL}"], **kw) == 0
        assert dec([f"--encoded_path={out / 'speech.lyra'}",
                    f"--output_dir={out}", f"--sample_rate_hz={rate}",
                    "--bitrate=6000", "--fixed_packet_loss_pattern=0.1:0.2",
                    f"--model_path={SMALL}"], **kw) == 0
        outs[name] = ((out / "speech.lyra").read_bytes(),
                      wav.read_wav_int16(str(out / "speech_decoded.wav")))
    (jax_lyra, jax_out), (lyra, out) = outs["jax"], outs["port"]
    assert lyra == jax_lyra and len(lyra) == 30 * 15
    assert out.sample_rate_hz == rate and len(out.samples) == 30 * hop
    assert np.abs(out.samples.astype(int) - jax_out.samples.astype(int)
                  ).max() <= 1
    assert "Samples per second" in caplog.text


def test_cli_exit_codes_match_jax(tmp_path):
    bad = tmp_path / "bad.wav"
    bad.write_bytes(b"not a wav at all")
    empty = tmp_path / "empty.lyra"
    empty.write_bytes(b"")
    for enc, dec, kw in ((jax_encoder_main.main, jax_decoder_main.main, {}),
                         (encoder_main.main, decoder_main.main, CPU)):
        out = str(tmp_path / "out")
        assert enc([f"--input_path={bad}", f"--output_dir={out}",
                    f"--model_path={SMALL}"], **kw) == 1
        assert dec([f"--encoded_path={empty}", f"--output_dir={out}",
                    f"--model_path={SMALL}"], **kw) == 1
        assert dec([f"--encoded_path={empty}", f"--output_dir={out}",
                    "--bitrate=1234", f"--model_path={SMALL}"], **kw) == 1


def test_cli_missing_model_fails_with_the_config_message(tmp_path, caplog):
    src = tmp_path / "a.wav"
    wav.write_wav_int16(str(src), _wave(2, 16000, 3200), 16000, 1)
    lyra = tmp_path / "a.lyra"
    lyra.write_bytes(bytes(15))
    missing = str(tmp_path / "no_model")
    assert encoder_main.main([f"--input_path={src}",
                              f"--output_dir={tmp_path}",
                              f"--model_path={missing}"], **CPU) == 1
    assert decoder_main.main([f"--encoded_path={lyra}",
                              f"--output_dir={tmp_path}",
                              f"--model_path={missing}"], **CPU) == 1
    assert caplog.text.count("does not exist in") == 2


def test_batch_transcode_rows_match_the_single_stream_facades(tmp_path):
    rates = (16000, 16000, 48000, 16000, 48000)
    hops = (6, 9, 7, 4, 8)
    waves = [_wave(10 + i, r, n * config.num_samples_per_hop(r) + 5 * i)
             for i, (r, n) in enumerate(zip(rates, hops))]
    for rate in (16000, 48000):
        group = [w for w, r in zip(waves, rates) if r == rate]
        encoded = batch_transcode.encode_batch(group, rate, 6000, SMALL,
                                               device="cpu")
        decoded = batch_transcode.decode_batch(encoded, rate, 6000, SMALL,
                                               seed=0, device="cpu")
        for w, enc, dec in zip(group, encoded, decoded):
            hop = config.num_samples_per_hop(rate)
            whole = len(w) // hop * hop
            assert enc == cli_lib.encode_wav(w[:whole], 1, rate, 6000, False,
                                             False, SMALL, device="cpu")
            ref = cli_lib.decode_features(
                enc, config.bitrate_to_packet_size(6000), False,
                LyraDecoder(rate, model_path=SMALL, seed=0, device="cpu"))
            assert len(dec) == len(ref) == whole
            assert np.abs(dec.astype(int) - ref.astype(int)).max() <= 1

    # The CLI over files of both rates, two of them with the same stem.
    for i, (w, r) in enumerate(zip(waves, rates)):
        d = tmp_path / "in" / f"spk{i % 2}"
        d.mkdir(parents=True, exist_ok=True)
        wav.write_wav_int16(str(d / f"utt{i // 2}.wav"), w, r, 1)
    out = tmp_path / "out"
    args = ["--input_glob", str(tmp_path / "in" / "*" / "*.wav"),
            "--output_dir", str(out), "--bitrate", "6000",
            "--model_path", SMALL]
    assert batch_transcode.main(args + ["--mode", "transcode"], **CPU) == 0
    got = sorted(os.path.basename(p) for p in glob.glob(str(out / "*.wav")))
    assert got == sorted(f"{stem}_decoded.wav" for stem in (
        "spk0_utt0", "spk1_utt0", "spk0_utt1", "spk1_utt1", "utt2"))
    assert batch_transcode.main(args + ["--mode", "encode"], **CPU) == 0
    data = (out / "spk1_utt0.lyra").read_bytes()  # waves[1]
    assert len(data) == hops[1] * config.bitrate_to_packet_size(6000)
    assert batch_transcode.main(
        ["--input_glob", str(out / "*.lyra"), "--output_dir", str(out / "d"),
         "--bitrate", "6000", "--mode", "decode", "--model_path", SMALL],
        **CPU) == 0
    assert len(wav.read_wav_int16(str(out / "d" / "spk1_utt0_decoded.wav"))
               .samples) == hops[1] * 320
    (tmp_path / "in" / "bad.wav").write_bytes(b"not a wav")
    assert batch_transcode.main(
        args[:1] + [str(tmp_path / "in" / "*.wav")] + args[2:], **CPU) == 1
    assert batch_transcode.main(
        args[:1] + [str(tmp_path / "*.nope")] + args[2:], **CPU) == 1


def test_run_benchmark_rows_csv_and_trace(tmp_path):
    result = benchmark.run_benchmark(
        num_cond_vectors=3, batch=2, num_bits=120, model_path=SMALL,
        csv_path=str(tmp_path / "bench.csv"),
        profile_dir=str(tmp_path / "trace"), device="cpu")
    rows = result["rows"]
    assert list(rows) == ["feature_extractor", "quantizer_quantize",
                          "quantizer_decode", "model_decode"]
    for name, r in rows.items():
        assert r.num_calls == 3, name
        assert 0 < r.min_us <= r.mean_us <= r.max_us < 60e6, name
        assert r.stdev_us >= 0, name
    total_us = sum(r.mean_us for r in rows.values())
    assert result["total_mean_us"] == pytest.approx(total_us)
    assert result["streams_per_chip"] == pytest.approx(2 * 0.02e6 / total_us)
    csv = (tmp_path / "bench.csv").read_text().splitlines()
    assert csv[0] == "stage,max_us,min_us,mean_us,stdev_us,num_calls"
    assert len(csv) == 5
    for line in csv[1:]:
        stage, *vals = line.split(",")
        assert float(vals[0]) == pytest.approx(rows[stage].max_us, rel=1e-6)
        assert float(vals[2]) == pytest.approx(rows[stage].mean_us, rel=1e-6)
    traces = glob.glob(str(tmp_path / "trace" / "*.json"))
    assert len(traces) == 1
    text = open(traces[0]).read()
    assert all(name in text for name in rows)


def test_benchmark_toggles_flags_and_modes(capsys):
    assert benchmark.main([
        "--num_cond_vectors=2", "--batch=1", f"--model_path={SMALL}",
        "--benchmark_quantizer=false", "--benchmark_generative_model=0",
    ], **CPU) == 0
    out = capsys.readouterr().out
    for row in ("feature_extractor", "quantizer_quantize",
                "quantizer_decode", "model_decode"):
        assert row in out
    with pytest.raises(SystemExit):
        benchmark.main(["--benchmark_quantizer=maybe"], **CPU)
    assert benchmark.main(["--mode=fakequant", "--num_cond_vectors=2",
                           f"--model_path={SMALL}"], **CPU) == 0
    assert "mode fakequant, backend plain" in capsys.readouterr().out
    result = benchmark.run_benchmark(2, 1, 64, SMALL, mode="bf16",
                                     benchmark_feature_extraction=False,
                                     device="cpu")
    assert result["rows"]["model_decode"].num_calls == 2


def test_melspec_benchmark_runs(capsys):
    assert melspec_benchmark.main(["--iters", "2"], **CPU) == 0
    out = capsys.readouterr().out
    assert out.count("frames/s") == 9 and "hop=  320 batch= 4096" in out


# ---- the examples (lyra_tpu_torch/examples) ----------------------------------


@pytest.fixture(scope="module")
def speech_wav(tmp_path_factory):
    """A seeded 16 kHz wav the examples read through --input."""
    path = str(tmp_path_factory.mktemp("examples") / "speech.wav")
    wav.write_wav_int16(path, _wave(11, 16000, 16000), 16000)
    return path


def test_drain_migrate_and_loopback_examples(tmp_path, speech_wav, capsys):
    """Mirror of tests/test_tools.py::test_examples_run_end_to_end: the
    drain/migrate demo (whose own exit code asserts bitwise-equal
    post-migration audio) and the loopback call (network simulation,
    jitter buffer, PLC) complete at 1 caller and 4 + 4 ticks."""
    from lyra_tpu_torch.examples import drain_migrate, loopback_call

    assert drain_migrate.main(
        ["--callers", "1", "--ticks_before_drain", "4", "--ticks_after", "4",
         "--input", speech_wav, "--model_path", SMALL,
         "--out_dir", str(tmp_path / "mig")], **CPU) == 0
    assert "oracle: 0" in capsys.readouterr().out
    assert len(wav.read_wav_int16(str(tmp_path / "mig" / "caller0.wav"))
               .samples) == 8 * 320
    assert loopback_call.main(
        ["--callers", "1", "--seconds", "0.16", "--input", speech_wav,
         "--model_path", SMALL, "--out_dir", str(tmp_path / "call")],
        **CPU) == 0
    assert len(wav.read_wav_int16(str(tmp_path / "call" / "caller0.wav"))
               .samples) == 8 * 320


@pytest.mark.parametrize("extra", [[], ["--mixed", "--callers", "3"],
                                   ["--red", "1", "--loss", "0.3"]],
                         ids=["plain", "mixed", "red"])
def test_udp_call_example(tmp_path, speech_wav, capsys, extra):
    """Mirror of tests/test_tools.py::test_udp_call_example (UDP datagrams
    → jitter buffer → async wire decode reports a measured latency, every
    hop matched on a lossless loopback; --mixed rides the per-row-bitrate
    wire path), and --red over the per-datagram Python drain: the lost
    datagrams' redundant copies heal holes."""
    from lyra_tpu_torch.examples import udp_call

    argv = ["--seconds", "0.4", "--callers", "2", "--loss", "0.0",
            "--input", speech_wav, "--model_path", SMALL,
            "--out_dir", str(tmp_path / "udp"), *extra]
    assert udp_call.main(argv, **CPU) == 0
    out = capsys.readouterr().out
    assert "wire-send→playout latency" in out
    callers = 3 if "--mixed" in extra else 2
    assert (tmp_path / "udp" / f"caller{callers - 1}.wav").exists()
    if "--red" in extra:
        heals = int(out.split("red heals: ")[1].split()[0])
        assert heals > 0 and "'late_drops': 0" in out
    else:
        assert "0 dropped" in out


def test_conference_call_example(tmp_path, speech_wav, capsys):
    """The bridge example end to end at 2 callers (one room): serve_main
    --mode bridge in a thread, reply-routed downlink to each caller's own
    socket; the listener hears the speaker (the example's own exit code),
    and both callers got downlink."""
    from lyra_tpu_torch.examples import conference_call

    assert conference_call.main(
        ["--seconds", "0.4", "--callers", "2", "--input", speech_wav,
         "--model_path", SMALL, "--out_dir", str(tmp_path / "conf")],
        **CPU) == 0
    out = capsys.readouterr().out
    for slot in range(2):
        hops = int(out.split(f"caller {slot} (")[1].split("): ")[1].split()[0])
        assert hops > 0, out
    assert (tmp_path / "conf" / "caller1_downlink.wav").exists()


def test_rate_adapt_example(capsys):
    """Mirror of tests/test_tools.py::test_rate_adapt_example: an
    oversubscribed token-bucket link drives the controller to walk the
    fleet down the bitrate ladder through HostControl.set_bitrate until
    the loss clears (the example's own exit code asserts convergence)."""
    from lyra_tpu_torch.examples import rate_adapt_call

    assert rate_adapt_call.main(["--callers", "2", "--seconds", "3",
                                 "--window_s", "0.3", "--model_path", SMALL],
                                **CPU) == 0
    out = capsys.readouterr().out
    assert "ADAPT OK" in out
    assert "rates s0:9200 s1:9200" in out  # started high...
    assert "rates s0:3200 s1:3200" in out  # ...converged low


@pytest.mark.parametrize("name", [
    "drain_migrate", "loopback_call", "udp_call", "conference_call",
    "rate_adapt_call", "multihost_migrate"])
def test_examples_need_the_card(name, tmp_path, monkeypatch):
    """Without a card every example raises the port's no-card error (no
    silent CPU run) before it builds an engine, opens a socket or spawns
    a process; multihost_migrate also refuses device="cpu", as its hosts
    run on the card only."""
    import importlib
    import subprocess

    import torch

    from lyra_tpu_torch.codec import engine

    def forbidden(*args, **kwargs):
        raise AssertionError("the example went past its device check")

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(subprocess, "Popen", forbidden)
    monkeypatch.setattr(engine.DecoderEngine, "__init__", forbidden)
    monkeypatch.setattr(engine.EncoderEngine, "__init__", forbidden)
    mod = importlib.import_module(f"lyra_tpu_torch.examples.{name}")
    argv = ["--model_path", SMALL]
    if name == "multihost_migrate":
        argv += ["--log_dir", str(tmp_path / "logs")]
    with pytest.raises(RuntimeError, match="CUDA device by default"):
        mod.main(argv)
    if name == "multihost_migrate":
        with pytest.raises(ValueError, match="on the card"):
            mod.main(argv, device="cpu")
        assert not (tmp_path / "logs").exists()
