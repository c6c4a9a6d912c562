"""The port's tracer (lyra_tpu_torch/utils/trace.py) and what the servers
record with it, on the CPU.

  * off: `span` is one shared null context, nothing is recorded and no
    counter moves;
  * on: spans nest, carry their parent and their tick (a span given none
    takes its parent's), `self_ns` takes the children's time out, and
    `drain` clears;
  * `mark` does nothing on the CPU and never builds the marker kernel;
  * `apart` keeps a stretch's counts out of the counters, and `add` adds
    them (a captured graph's counts, added at each replay);
  * a CPU EncoderServer → DecoderServer pair on the small fixture records,
    per tick of `tick_wire_async` and the flush after them, the span tree
    the servers' docstring gives, each drain under the id of the tick it
    drains, and counters equal to what the test computes from its own
    loss pattern and the drained flags;
  * wire bytes, sizes and audio are bitwise the same with tracing on and
    off.
"""

import os
import re

import numpy as np
import pytest
import torch

from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
from lyra_tpu_torch.tools.stream_server import DecoderServer, EncoderServer
from lyra_tpu_torch.utils import trace

SMALL = os.path.join(os.path.dirname(__file__), "golden", "synthetic_lyra",
                     "small")
CAP, STREAMS, TICKS = 5, 4, 12  # slot 4 stays empty
MARK_CU = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "lyra_tpu_torch", "ops", "csrc",
    "trace_mark.cu")


@pytest.fixture(autouse=True)
def tracer_off():
    trace.disable()
    trace.drain()
    yield
    trace.disable()
    trace.drain()


def test_off_records_nothing():
    a, b = trace.span("x", 3), trace.span("y")
    assert a is b and not trace.enabled()
    with a:
        trace.count("n", 5)
    assert trace.drain() == ([], {})


def test_on_nests_with_parents_and_ticks(monkeypatch):
    clock = iter(range(0, 1000, 10))
    monkeypatch.setattr(trace.time, "perf_counter_ns", lambda: next(clock))
    trace.enable()
    with trace.span("a", 3):
        with trace.span("b"):
            trace.count("n")
            trace.count("n", 2)
        with trace.span("c", 5):
            with trace.span("d"):
                pass
    with trace.span("e"):
        pass
    spans, counts = trace.drain()
    assert spans == [("a", 3, -1, 0, 70), ("b", 3, 0, 10, 20),
                     ("c", 5, 0, 30, 60), ("d", 5, 2, 40, 50),
                     ("e", None, -1, 80, 90)]
    assert counts == {"n": 3}
    assert trace.self_ns(spans) == [30, 10, 20, 10, 10]
    assert trace.drain() == ([], {})


def test_drain_inside_a_span_keeps_what_closed():
    trace.enable()
    with trace.span("outer", 1):
        with trace.span("inner"):
            pass
        spans, _ = trace.drain()
        assert [(s[0], s[1], s[2]) for s in spans] == [("inner", 1, -1)]
        with trace.span("later"):
            pass
    spans, _ = trace.drain()
    # "outer" opened before the drain: "later" gets no parent from it.
    assert [(s[0], s[2]) for s in spans] == [("later", -1)]


def test_mark_is_a_no_op_on_the_cpu():
    before = trace._lib.cache_info().currsize
    trace.enable()
    trace.mark("dec.plc", torch.zeros(2))
    trace.mark("graph.end", torch.device("cpu"))
    assert trace._lib.cache_info().currsize == before


def test_apart_keeps_counts_out_of_the_counters():
    trace.enable()
    trace.count("n")
    with trace.apart() as kept:
        trace.count("n", 2)
        trace.count("m")
    assert kept == {"n": 2, "m": 1}
    trace.add(kept)
    trace.add(kept)
    assert trace.drain()[1] == {"n": 5, "m": 2}


def test_segments_fit_the_marker_kernel():
    with open(MARK_CU) as f:
        most = int(re.search(r"kMaxSegments = (\d+)", f.read()).group(1))
    assert len(set(trace.SEGMENTS)) == len(trace.SEGMENTS) <= most


def _run(traced: bool):
    """TICKS ticks of tick_wire_async on both servers, then their flushes;
    → (wire, sizes, audio, received, comfort flags, spans, counters)."""
    enc = EncoderServer(CAP, engine=EncoderEngine(
        16000, SMALL, enable_dtx=True, device="cpu"), bitrate=6000)
    dec = DecoderServer(CAP, engine=DecoderEngine(
        16000, SMALL, emit_dtype="int16", device="cpu"))
    for server in (enc, dec):
        server.add_streams(range(STREAMS))
    rng = np.random.default_rng(11)
    pcm = np.clip(rng.normal(0, 3000, (TICKS, CAP, 320)), -32768,
                  32767).astype(np.int16)
    pcm[:, 1] = 0  # a silent stream: DTX noise hops
    lost = rng.random((TICKS, CAP)) < 0.2
    lost[3:, 2] = True  # a burst: concealment, the fade and comfort noise
    if traced:
        trace.enable()
    wires, sizes, audio, recvs, flags = [], [], [], [], []

    def decode(out):
        w, s = out
        wires.append(w)
        sizes.append(s)
        recv = ~lost[len(recvs)] & (s > 0)
        recvs.append(recv)
        got = dec.tick_wire_async(w, recv, s)
        if got is not None:
            audio.append(got)
            flags.append(dec._last_comfort.copy())

    for t in range(TICKS):
        out = enc.tick_wire_async(pcm[t])
        if out is not None:
            decode(out)
    decode(enc.flush_wire_async())
    audio.append(dec.flush_wire_async())
    flags.append(dec._last_comfort.copy())
    trace.disable()
    spans, counts = trace.drain()
    return (np.stack(wires), np.stack(sizes), np.stack(audio),
            np.stack(recvs), np.stack(flags), spans, counts)


def _tree(spans, kind):
    """[(tick, [(child, its tick, [(grandchild, its tick)])])] of each
    `<kind>.tick` span, in order."""
    kids = {i: [] for i in range(len(spans))}
    for i, s in enumerate(spans):
        if s[2] >= 0:
            kids[s[2]].append(i)
    return [(s[1], [(spans[c][0], spans[c][1],
                     [(spans[g][0], spans[g][1]) for g in kids[c]])
                    for c in kids[i]])
            for i, s in enumerate(spans) if s[0] == f"{kind}.tick"
            and s[2] == -1]


def test_servers_record_each_ticks_span_tree_and_counters():
    _, sizes, _, recv, flags, spans, counts = _run(traced=True)
    assert all(s[3] <= s[4] for s in spans)
    for kind, stage in (("enc", ["enc.stage", "enc.stage"]),
                        ("dec", ["dec.unpack", "dec.stage"])):
        tree = _tree(spans, kind)
        # TICKS submits, then the flush under the id of the tick it drains.
        assert [t for t, _ in tree] == [*range(TICKS), TICKS - 1]
        for t, children in tree[:TICKS]:
            submit = [(n, t, []) for n in stage + ["graph.replay",
                                                   f"{kind}.fetch"]]
            drain = [(f"{kind}.drain", t - 1, [("host.wait", t - 1)])]
            assert children == submit + (drain if t else []), (kind, t)
        assert tree[TICKS][1] == [(f"{kind}.drain", TICKS - 1,
                                   [("host.wait", TICKS - 1)])]
    active = np.arange(CAP) < STREAMS
    lost = active & ~recv
    cn = int((flags & lost).sum())
    assert cn > 0 and counts["dec.rows_comfort_noise"] == cn
    assert counts["dec.rows_concealed"] == int(lost.sum()) - cn
    assert counts["dec.rows_run"] == CAP * TICKS
    dtx = int((active & (sizes == 0)).sum())
    assert dtx > 0 and counts["enc.rows_dtx"] == dtx
    assert "graph.captures" not in counts  # no graph cache on the CPU


def test_tracing_changes_no_bit():
    off, on = _run(traced=False), _run(traced=True)
    assert off[5] == [] and off[6] == {}
    for a, b in zip(off[:5], on[:5]):
        np.testing.assert_array_equal(a, b)
