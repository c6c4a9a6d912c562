"""The frozen reference against the port on the CPU at a small size; the
comparison against the precision controls and the faults a cell can have.

On the CPU the port runs its kernels' plain versions, the same torch ops
the reference runs, so there the two agree to the bit.  A run with the
timed path broken underneath must come out not correct: a step that
returns its state unchanged, half the batch left out, a code altered where
it is produced, and the port computing below the configuration's
precision."""

from __future__ import annotations

import pytest
import torch

from conftest import FULL, make_root
from portbench import harness
from lyra_tpu_torch.codec import engine


def _run(root, **kw):
    result, _ = harness.run("tiny.cell", 2**31 + 3, 0.4, False, root=root,
                            device="cpu", **kw)
    return result


@pytest.mark.parametrize("config,rate", [("lyra-v2-f32-16k", 16000),
                                         ("lyra-v2-f32-16k", 48000)])
def test_reference_agrees_with_the_port(tmp_path, config, rate):
    result = _run(make_root(tmp_path, config=config, sample_rate_hz=rate))
    checks = result["checks"]
    assert checks["code_gap"]["value"] == 0.0
    assert checks["pcm_rms_err"]["value"] == 0.0
    assert result["correct"]


def test_bf16_port_fails_the_f32_comparison(tmp_path):
    result = _run(make_root(tmp_path), engine_kwargs={"mode": "bf16"})
    assert not result["correct"]
    assert result["checks"]["code_gap"]["value"] > \
        result["checks"]["code_gap"]["limit"]


def _state_unchanged(cls):
    step = cls._step_impl

    def broken(self, state, *inputs):
        *out, _ = step(self, state, *inputs)
        return (*out, state)
    return broken


def _half_batch(cls):
    step = cls._step_impl

    def broken(self, state, *inputs):
        *out, new = step(self, state, *inputs)
        half = out[0].shape[0] // 2
        out[0] = torch.cat([out[0][:half], torch.zeros_like(out[0][half:])])
        return (*out, new)
    return broken


def _code_altered(cls):
    step = cls._step_impl

    def broken(self, state, *inputs):
        indices, *rest = step(self, state, *inputs)
        indices = indices.clone()
        indices[:, 3] = (indices[:, 3] + 1) % 16
        return (indices, *rest)
    return broken


@pytest.mark.parametrize("cls,fault", [
    (engine.EncoderEngine, _state_unchanged),
    (engine.DecoderEngine, _state_unchanged),
    (engine.DecoderEngine, _half_batch),
    (engine.EncoderEngine, _code_altered),
], ids=["encoder-state-unchanged", "decoder-state-unchanged",
        "decoder-half-batch", "code-altered"])
def test_a_fault_is_not_correct(tmp_path, monkeypatch, cls, fault):
    monkeypatch.setattr(cls, "_step_impl", fault(cls))
    assert not _run(make_root(tmp_path))["correct"]


def test_fp8_control_fails_the_bf16_comparison(tmp_path):
    """The port's own fp8 path (the plain lowering with fp8 boundaries) in
    place of the bf16 program, on the full-width graphs, where its
    boundaries hold fp8."""
    root = make_root(tmp_path, config="lyra-v2-bf16-48k", fixture=FULL,
                     streams=4)
    assert _run(root)["correct"]
    control = _run(root, engine_kwargs={"backend": "plain",
                                        "boundary_store": "f8"})
    assert not control["correct"]


@pytest.mark.cuda
def test_tf32_control_fails_the_f32_comparison(tmp_path, cuda):
    """On the card, at full width: the float32 program passes, and the
    port's plain lowering with TF32 on in its place fails (TF32 is a
    tensor-core format: the card only)."""
    root = make_root(tmp_path, fixture=FULL, streams=64)
    program, _ = harness.run("tiny.cell", 7, 2.0, False, root=root)
    assert program["correct"], program["checks"]
    control, _ = harness.run("tiny.cell", 7, 2.0, False, root=root,
                             engine_kwargs={"backend": "plain"}, tf32=True)
    assert not control["correct"], control["checks"]
