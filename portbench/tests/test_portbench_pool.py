"""The fleet path (portbench/fleet.py): a mix that gives `rates` served by a
ServerPool pair with churn.  Its traffic and layout, the sample, the work
counted per row, and whole runs on the CPU at a tiny size: the port
agrees with the reference to the bit, and a run with the admission or
the decoder's bitrate broken underneath comes out not correct."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import FULL, make_root, read_json
from portbench import compare, harness, profiling, traffic, work
from lyra_tpu_torch.codec import engine
from lyra_tpu_torch.tools import stream_server

MIX = read_json("portbench", "traffic", "mixed-fleet.json")


def _pool_root(tmp_path, config="lyra-v2-f32-16k", **changes):
    """A tiny fleet: 4 streams at 8 and 48 kHz in waves of 2, at 3.2 and
    9.2 kbps, 4 churn events every 20 ticks (3 in the first 12) and
    bursts every 10 ticks on every 4th row; the float32 configuration
    unless named, with `changes`, on the small graphs unless given."""
    root = make_root(tmp_path, config=config, mix="mixed-fleet", streams=4,
                     **changes)
    path = os.path.join(root, "portbench", "traffic", "tiny-mix.json")
    with open(path) as f:
        m = json.load(f)
    m.update(rates={"8000": 0.5, "48000": 0.5}, wave_capacity=2,
             bitrates={"3200": 0.5, "9200": 0.5}, churn_per_s=2.5)
    with open(path, "w") as f:
        json.dump(m, f)
    return root


def _run(root, monkeypatch, seconds=0.3):
    """One run on the CPU, its profiled stretch run but not profiled (the
    CPU has no device timeline to read)."""
    def unprofiled(run_ticks, cuda=True):
        run_ticks()
        return {"by_name": {}, "kernels": 0, "busy_s": 0.25,
                "window_s": 0.25, "gaps": []}, 1

    monkeypatch.setattr(profiling, "recorded", unprofiled)
    return harness.run("tiny.cell", 2**31 + 41, seconds, False, root=root,
                       device="cpu")


def test_the_layout_of_the_mixed_fleet():
    lay = traffic.Layout.of(MIX)
    assert lay.streams == {8000: 410, 16000: 1229, 32000: 409, 48000: 2048}
    assert lay.wave_rates == (8000,) + (16000,) * 3 + (32000,) \
        + (48000,) * 4
    assert lay.slots == 4608
    assert lay.wave_streams() == [410, 410, 410, 409, 409] + [512] * 4


@pytest.mark.parametrize("total,weights,expected", [
    (4096, [0.1, 0.3, 0.1, 0.5], [410, 1229, 409, 2048]),
    (410, [0.25, 0.5, 0.25], [103, 205, 102]),
    (7, [1, 1, 1], [3, 2, 2]),
])
def test_shares_by_largest_remainder(total, weights, expected):
    assert traffic.shares(total, weights) == expected


def _traffic(seed, **mix):
    m = {**MIX, "pool_ticks": 1, **mix}
    return traffic.Traffic(m, seed, 48000, 20, "cpu")


def test_every_stretch_of_a_cycle_churns_each_wave_alike():
    """16 events every 20 ticks (1 % of 4096 streams a second), each wave
    its share, in any 20 ticks and for every seed; the stream ended and
    the new bitrate come from the seed."""
    one, two = _traffic(1), _traffic(2**31 + 5)
    counts = set()
    for tr in (one, two):
        for start in (0, 7, 113):
            waves = [w for t in range(start, start + traffic.CHURN_CYCLE)
                     for w, _, _ in tr.churn(t)]
            counts.add(tuple(np.bincount(waves, minlength=9)))
    assert counts == {(2, 2, 2, 1, 1, 2, 2, 2, 2)}
    a, b = one.churn(3), two.churn(3)
    assert [e[0] for e in a] == [e[0] for e in b] and a != b
    assert {e[2] for t in range(400) for e in one.churn(t)} == {
        3200, 6000, 9200}


def test_setup_bitrates_are_exact_shares_in_a_drawn_order():
    a, b = _traffic(1), _traffic(2)
    for rate, n in a.layout.streams.items():
        x, y = a.setup_bitrates(rate), b.setup_bitrates(rate)
        assert x.size == n and sorted(x) == sorted(y)
        assert not np.array_equal(x, y)
    got = np.unique(a.setup_bitrates(8000), return_counts=True)
    assert [x.tolist() for x in got] == [[3200, 6000, 9200], [103, 205, 102]]


def test_pool_pcm_holds_each_rows_own_hop_left_aligned():
    tr = _traffic(3, pool_ticks=2)
    assert tr.pool.shape == (2, 4608, 960) and tr.rows == 4608
    hops = tr.layout.row_rates() // 50
    for row in (0, 600, 2100, 4607):
        pcm = tr.pcm(1)[row]
        assert np.all(pcm[hops[row]:] == 0) and np.any(pcm[:hops[row]])
    assert tr.received(5).shape == (4608,)
    assert traffic.bits_of(3200, 20) == 64
    assert traffic.bits_of(9200, 20) == 184


def test_the_sample_covers_every_rate_and_bitrate():
    """On many seeds: 32 admitted rows, half bursty, every wave at least
    2 (a fault in one wave's server is sampled), every rate and bitrate at
    least 4."""
    for seed in [2**31 + 9] + list(range(15)):
        tr = _traffic(seed)
        lay = tr.layout
        rates, waves = lay.row_rates(), lay.row_waves()
        admitted = np.zeros(lay.slots, bool)
        bits = np.zeros(lay.slots, np.int64)
        for w, n in enumerate(lay.wave_streams()):
            admitted[w * lay.capacity:w * lay.capacity + n] = True
        for rate in lay.streams:
            rows = np.flatnonzero(admitted & (rates == rate))
            bits[rows] = [traffic.bits_of(b, 20)
                          for b in tr.setup_bitrates(rate)]
        rows = compare.sample_fleet_rows(tr.seed, admitted, rates, bits,
                                         waves, tr.burst_rows, 32)
        assert rows.size == 32 and admitted[rows].all()
        assert tr.burst_rows[rows].sum() == 16
        assert np.bincount(waves[rows], minlength=9).min() >= 2, seed
        assert min(np.unique(rates[rows], return_counts=True)[1]) >= 4
        assert set(np.unique(rates[rows])) == set(lay.streams)
        assert min(np.unique(bits[rows], return_counts=True)[1]) >= 4
        assert len(np.unique(bits[rows])) == 3


def test_rvq_work_counts_each_rows_stages():
    """A uniform 120-bit mix gives the count of one bitrate for all, bit
    for bit; a mixed one each row's own stages."""
    cfg = {"mode": "bf16", "model_dir": FULL}
    b, s = 4096, 30
    flop = b * s * (16 * 2 * 64 + 64)
    nbytes = 4 * (b * 64 + s * 16 * (64 + 1) + b * s)
    uniform = work.Work(cfg, b, 120)
    assert uniform.rvq() == (float(flop), float(nbytes))
    assert work.Work(cfg, b, np.full(b, 120)).rvq() == uniform.rvq()
    mixed = work.Work(cfg, 3, np.array([64, 120, 184]))
    assert mixed.rvq() == (float((16 + 30 + 46) * (16 * 2 * 64 + 64)),
                           float(4 * (3 * 64 + 46 * 16 * 65 + 92)))
    assert mixed.tick_flop() - mixed.rvq()[0] == pytest.approx(
        3 * (uniform.tick_flop() - uniform.rvq()[0]) / b)


def test_a_pool_mix_with_churn_runs_correct(tmp_path, monkeypatch):
    """Two rates, two bitrates, churn on the schedule and set-up's: every
    tenure of every row agrees with the reference to the bit."""
    result, notes = _run(_pool_root(tmp_path), monkeypatch)
    assert result["correct"], result["checks"]
    checks = result["checks"]
    assert checks["code_gap"]["value"] == 0.0
    assert checks["pcm_rms_err"]["value"] == 0.0
    assert checks["bad_sizes"]["value"] == 0.0
    churn = next(n for n in notes if n.startswith("churn events"))
    assert "by rate (Hz) {8000: 2, 48000: 2}" in churn
    assert int(churn.split("in the run ")[1].split(";")[0]) >= 2
    compared = next(n for n in notes if n.startswith("compared"))
    assert int(compared.split()[1]) > 4  # more tenures than rows


def _reset_skipped(monkeypatch):
    monkeypatch.setattr(engine._Compiled, "_reset",
                        lambda self, state, mask, graphs=None, **init: state)


def _decoded_at_another_bitrate(monkeypatch):
    sizes_to_nq = stream_server.DecoderServer._sizes_to_nq

    def wrong(self, sizes, received, width):
        nq, received = sizes_to_nq(self, sizes, received, width)
        return np.where(nq == 46, 30, nq).astype(nq.dtype), received

    monkeypatch.setattr(stream_server.DecoderServer, "_sizes_to_nq", wrong)


@pytest.mark.parametrize("fault", [_reset_skipped,
                                   _decoded_at_another_bitrate],
                         ids=["churned-row-not-reset",
                              "decoded-at-another-bitrate"])
def test_a_pool_fault_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    result, _ = _run(_pool_root(tmp_path), monkeypatch)
    assert not result["correct"], result["checks"]
