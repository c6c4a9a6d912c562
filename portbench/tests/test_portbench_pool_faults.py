"""The faults a served cell can have, planted under a fleet's run on the
CPU (the pool path's comparison follows tenures, not rows): a step that
returns its state unchanged, half of a wave's batch left out, and a code
altered where the encoder produces it all come out not correct."""

from __future__ import annotations

import pytest

from lyra_tpu_torch.codec import engine
from test_portbench_pool import _pool_root, _run
from test_portbench_reference import (_code_altered, _half_batch,
                                      _state_unchanged)


@pytest.mark.parametrize("cls,fault", [
    (engine.EncoderEngine, _state_unchanged),
    (engine.DecoderEngine, _state_unchanged),
    (engine.DecoderEngine, _half_batch),
    (engine.EncoderEngine, _code_altered),
], ids=["encoder-state-unchanged", "decoder-state-unchanged",
        "decoder-half-batch", "code-altered"])
def test_a_fault_under_a_fleet_is_not_correct(tmp_path, monkeypatch, cls,
                                               fault):
    monkeypatch.setattr(cls, "_step_impl", fault(cls))
    result, _ = _run(_pool_root(tmp_path), monkeypatch)
    assert not result["correct"], result["checks"]

