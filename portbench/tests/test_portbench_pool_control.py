"""The bf16 configuration's precision control under a fleet: the port's
plain lowering with fp8 boundaries in place of the program fails the
comparison that the bf16 program passes."""

from __future__ import annotations

from conftest import FULL
from portbench import harness
from test_portbench_pool import _pool_root, _run


def test_fp8_control_fails_under_a_fleet(tmp_path, monkeypatch):
    """The bf16 configuration's control (the port's plain lowering with
    fp8 boundaries) in place of the program under a fleet, on the
    full-width graphs; the bf16 program itself passes."""
    root = _pool_root(tmp_path, config="lyra-v2-bf16-48k", fixture=FULL)
    result, _ = _run(root, monkeypatch)
    assert result["correct"], result["checks"]
    control, _ = harness.run("tiny.cell", 2**31 + 41, 0.3, False, root=root,
                             device="cpu", engine_kwargs={
                                 "backend": "plain", "boundary_store": "f8"})
    assert not control["correct"], control["checks"]
