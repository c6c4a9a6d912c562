"""A fault in one wave's server, under a fleet whose rate has two waves:
the comparison follows that wave's tenures too, so a run whose admissions
leave one wave's state as it was comes out not correct, while the same
fleet unbroken reads correct.  And a churned stream's bad packets still
count in `failed` after its slot's counter is reset."""

from __future__ import annotations

import json
import os

import numpy as np
import pytest

from conftest import make_root
from portbench import fleet, harness, traffic
from test_portbench_pool import _run


def _three_wave_root(tmp_path):
    """6 streams: 2 at 8 kHz in one wave, 4 at 48 kHz in two waves of 2;
    3.2 and 9.2 kbps; 6 churn events every 20 ticks and set-up's 2 on
    every wave."""
    root = make_root(tmp_path, mix="mixed-fleet", streams=6)
    path = os.path.join(root, "portbench", "traffic", "tiny-mix.json")
    with open(path) as f:
        m = json.load(f)
    m.update(rates={"8000": 1, "48000": 2}, wave_capacity=2,
             bitrates={"3200": 0.5, "9200": 0.5}, churn_per_s=2.5)
    with open(path, "w") as f:
        json.dump(m, f)
    return root


class _NoReset:
    """An engine whose admissions leave the state as it was."""

    def __init__(self, engine):
        self._engine = engine

    def _reset(self, state, mask, graphs=None, **init):
        return state

    def __getattr__(self, name):
        return getattr(self._engine, name)


def _last_wave_not_reset(side):
    class Broken(fleet.Fleet):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            server = getattr(self, side).servers[-1]
            server.engine = _NoReset(server.engine)
    return Broken


def test_a_three_wave_fleet_runs_correct(tmp_path, monkeypatch):
    result, notes = _run(_three_wave_root(tmp_path), monkeypatch)
    assert result["correct"], result["checks"]
    churn = next(n for n in notes if n.startswith("churn events"))
    assert "by rate (Hz) {8000: 2, 48000: 4}" in churn


@pytest.mark.parametrize("side", ["enc", "dec"])
def test_one_waves_admissions_not_reset_is_not_correct(tmp_path, monkeypatch,
                                                       side):
    monkeypatch.setattr(harness, "Fleet", _last_wave_not_reset(side))
    result, _ = _run(_three_wave_root(tmp_path), monkeypatch)
    assert not result["correct"], result["checks"]


class _Pool:
    """Two waves of 2 slots; an admission takes the slot freed last and
    resets its counter, as DecoderServer.add_streams does."""

    def __init__(self):
        self.servers = [type("S", (), {})() for _ in range(2)]
        for s in self.servers:
            s.bad_packets = np.zeros(2, np.int64)
        self.where = {sid: divmod(sid, 2) for sid in range(4)}

    @property
    def bad_packets(self):
        return np.concatenate([s.bad_packets for s in self.servers])

    def remove_stream(self, sid):
        self.freed = self.where.pop(sid)

    def add_stream(self, sid, sample_rate_hz, bitrate=None):
        w, i = self.where[sid] = self.freed
        self.servers[w].bad_packets[i] = 0
        return w * 2 + i


def test_an_ended_streams_bad_packets_still_count():
    f = fleet.Fleet.__new__(fleet.Fleet)
    f.layout = traffic.Layout((8000, 48000), 2, {8000: 2, 48000: 2})
    f.traffic = type("T", (), {"churn": lambda self, t: [(1, 0.0, 6000)],
                               "hop_ms": 20})()
    f.enc, f.dec = _Pool(), _Pool()
    f.owner, f.gen = np.arange(4), np.ones(4, np.int64)
    f.bits = np.full(4, 120)
    f.tenures = [fleet.Tenure(r, f.layout.row_rates()[r], 120, 0)
                 for r in range(4)]
    f.events = f.ended_bad_packets = 0
    f.dec.servers[1].bad_packets[:] = [3, 1]
    before = harness._bad_packets(f.dec, f)
    f.churn(5)
    assert f.owner[2] == 4 and f.dec.bad_packets.tolist() == [0, 0, 0, 1]
    assert harness._bad_packets(f.dec, f) == before == 4
