"""What a configuration says of its codec, and nothing else does: its hop
(`hop_ms`), the port's engine classes (`engines`), the plain reference
that judges them (`reference`) and the class that counts a tick's work
(`work`).  Each key is read from a copy of a configuration under a
temporary root, and a configuration without one is refused at load."""

from __future__ import annotations

import ast
import json
import os
import re
import textwrap

import pytest

from conftest import REPO, make_root
from portbench import harness, spec
from portbench.metrics import tick_mfu_pct
from portbench.traffic import Traffic, bits_of
from test_portbench_pool import _pool_root
from test_portbench_reference import _run

SEED = 2**31 + 29


def _module(tmp_path, monkeypatch, name: str, source: str) -> None:
    """A module `name` importable from `tmp_path`, as a checkout's own."""
    with open(os.path.join(tmp_path, name + ".py"), "w") as f:
        f.write(textwrap.dedent(source))
    monkeypatch.syspath_prepend(str(tmp_path))


def test_a_reference_with_scaled_code_gaps_is_not_correct(tmp_path,
                                                          monkeypatch):
    """The comparison runs the reference the configuration names: one
    whose code_gaps reads the features × 1.5 fails the port that the
    Lyra reference passes to the bit."""
    _module(tmp_path, monkeypatch, "scaled_reference", """
        from portbench.reference import codec
        from portbench.reference.codec import (
            Decoder, Encoder, stages_of, unpack_wire)

        def code_gaps(features, codes, codebooks):
            return codec.code_gaps(1.5 * features, codes, codebooks)
    """)
    result = _run(make_root(tmp_path, reference="scaled_reference"))
    check = result["checks"]["code_gap"]
    assert not result["correct"] and check["value"] > check["limit"]


def test_a_doubled_work_doubles_tick_mfu_pct(tmp_path, monkeypatch):
    _module(tmp_path, monkeypatch, "doubled_work", """
        from portbench import work

        class Work(work.Work):
            def tick_flop(self):
                return 2 * super().tick_flop()
    """)
    window = {"ticks": 50, "window_s": 1.0, "streams": 4, "hop_s": 0.02}
    mfu = []
    for i, name in enumerate(("portbench.work:Work", "doubled_work:Work")):
        cfg = spec.load(make_root(tmp_path / str(i), work=name),
                        "tiny.cell").config
        w = spec.named(cfg["work"])(cfg, 4, 120)
        mfu.append(tick_mfu_pct.read({"work": w, "window": window}))
    assert mfu[1] == pytest.approx(2 * mfu[0], rel=1e-12) and mfu[0] > 0


@pytest.mark.parametrize("fleet", [False, True], ids=["pair", "fleet"])
def test_hop_ms_sets_the_rows_the_bits_and_both_stream_formulas(tmp_path,
                                                                fleet):
    """40 ms against the 20 ms of the Lyra configuration: twice the PCM a
    row, twice the bits of a bitrate, twice the churn events of a cycle,
    and twice the streams that a tick carries in realtime_streams' and
    card_streams' formula."""
    traffic = {}
    for hop_ms in (20, 40):
        where = tmp_path / str(hop_ms)
        root = (_pool_root(where, hop_ms=hop_ms) if fleet
                else make_root(where, hop_ms=hop_ms))
        cell = spec.load(root, "tiny.cell")
        traffic[hop_ms] = t = Traffic(cell.mix, SEED, 16000,
                                      cell.config["hop_ms"], "cpu")
        assert t.hop_s == hop_ms / 1000
        if fleet:  # each row's own rate × hop, left-aligned in the widest
            assert t.hop == 48000 * hop_ms // 1000
            assert (t.pcm(0)[0, 8000 * hop_ms // 1000:] == 0).all()
        else:
            assert t.pcm(0).shape == (t.streams, 16000 * hop_ms // 1000)
    assert bits_of(6000, 40) == 2 * bits_of(6000, 20) == 240
    if fleet:
        events = {h: sum(len(e) for e in t._cycle)
                  for h, t in traffic.items()}
        assert events[40] == 2 * events[20] == 8
    for ticks, seconds in ((300, 2.5), (harness.PROFILED_TICKS, 0.25)):
        carried = {h: harness.streams_carried(t.streams, ticks, t.hop_s,
                                              seconds)
                   for h, t in traffic.items()}
        assert carried[40] == pytest.approx(2 * carried[20], rel=1e-15)


@pytest.mark.parametrize("fleet", [False, True], ids=["pair", "fleet"])
def test_the_servers_hold_the_engines_the_configuration_names(
        tmp_path, monkeypatch, fleet):
    _module(tmp_path, monkeypatch, "sub_engines", """
        from lyra_tpu_torch.codec import engine

        class Encoder(engine.EncoderEngine):
            pass

        class Decoder(engine.DecoderEngine):
            pass
    """)
    names = {"encoder": "sub_engines:Encoder",
             "decoder": "sub_engines:Decoder"}
    root = (_pool_root(tmp_path, engines=names) if fleet
            else make_root(tmp_path, engines=names))
    cell = spec.load(root, "tiny.cell")
    cfg = cell.config
    traffic = Traffic(cell.mix, SEED, int(cfg["sample_rate_hz"]),
                      cfg["hop_ms"], "cpu")
    enc, dec, pool = harness._pair(cfg, traffic, "cpu", None)
    enc_servers = enc.servers if fleet else [enc]
    dec_servers = dec.servers if fleet else [dec]
    assert (pool is not None) == fleet and len(enc_servers) == 1 + fleet
    assert {type(s.engine) for s in enc_servers} == {
        spec.named(names["encoder"])}
    assert {type(s.engine) for s in dec_servers} == {
        spec.named(names["decoder"])}


@pytest.mark.parametrize("key", list(spec.REQUIRED) + [
    "engines.encoder", "engines.decoder"])
def test_a_configuration_without_a_codec_key_is_refused(tmp_path, key):
    root = make_root(tmp_path)
    path = os.path.join(root, "portbench", "configs", "tiny.json")
    with open(path) as f:
        cfg = json.load(f)
    *outer, last = key.split(".")
    (cfg[outer[0]] if outer else cfg).pop(last)
    with open(path, "w") as f:
        json.dump(cfg, f)
    with pytest.raises(ValueError, match=repr(last)):
        spec.load(root, "tiny.cell")


def test_a_mix_sets_its_setup_ticks(tmp_path, monkeypatch):
    """A mix's `setup_ticks` are set-up's ticks (6 where it gives none);
    fewer than 6 are refused."""
    warm_up = harness._Loop.warm_up
    after = []

    def counted(self):
        warm_up(self)
        after.append(self.t)

    monkeypatch.setattr(harness._Loop, "warm_up", counted)
    mix = os.path.join("portbench", "traffic", "tiny-mix.json")
    root = make_root(tmp_path)
    with open(os.path.join(root, mix)) as f:
        m = json.load(f)
    with open(os.path.join(root, mix), "w") as f:
        json.dump({**m, "setup_ticks": 9}, f)
    assert _run(root)["correct"] and after == [9]
    assert Traffic(m, SEED, 16000, 20, "cpu").setup_ticks == 6
    with pytest.raises(ValueError, match="setup_ticks"):
        Traffic({**m, "setup_ticks": 5}, SEED, 16000, 20, "cpu")


GENERIC = ("harness", "traffic", "compare", "fleet", "spec", "traced",
           "profiling", "calibrate", "__main__")


@pytest.mark.parametrize("name", GENERIC)
def test_no_generic_module_assumes_the_codec(name):
    """The harness's own modules take the hop, the engines, the reference
    and the work from the configuration: none names Lyra's engines, its
    reference or its work count, or a 20 ms hop (0.020 s, 50 a second)."""
    with open(os.path.join(REPO, "portbench", name + ".py")) as f:
        text = f.read()
    imported = set()
    for node in ast.walk(ast.parse(text)):
        if isinstance(node, ast.Import):
            imported |= {a.name for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            imported |= {f"{node.module}.{a.name}" for a in node.names}
    assert not {m for m in imported if m.startswith((
        "lyra_tpu_torch.codec", "portbench.reference", "portbench.work"))}
    assert not re.search(r"0\.020|// ?50\b|\* ?50\b", text)
    assert "bits // 4" not in text and "8 // 4" not in text
