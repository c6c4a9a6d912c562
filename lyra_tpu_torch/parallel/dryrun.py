"""The multi-device dry run: one sharded codec tick and one sharded bridge
tick on tiny shapes — the port's counterpart of
`__graft_entry__.dryrun_multichip`.

    python -m lyra_tpu_torch.parallel.dryrun N [--model_path DIR]

runs it over the first N attached cards.  There is no fallback to the
CPU: a caller that wants a CPU mesh passes `devices=["cpu"] * n`.
"""

from __future__ import annotations

import argparse
import sys
from typing import Optional, Sequence

import numpy as np

from lyra_tpu_torch import config


def _leaf_devices(tree, out):
    if isinstance(tree, dict):
        for v in tree.values():
            _leaf_devices(v, out)
    else:
        out.append(tree.device)
    return out


def dryrun_multichip(n_devices: int, *, devices: Optional[Sequence] = None,
                     model_path: str = config.DEFAULT_MODEL_PATH) -> None:
    """Run the lockstep codec tick (encode → wire bytes → decode) with all
    streaming state sharded over an `n_devices` mesh, 2 streams per shard
    and every third packet lost, then one conference-bridge wire tick on
    the same mesh with shard-affine rooms of 2.  Checks the output shapes
    and that every state leaf lives on its own shard's device; raises on
    any failure."""
    from lyra_tpu_torch import packet
    from lyra_tpu_torch.codec.engine import DecoderEngine, EncoderEngine
    from lyra_tpu_torch.parallel.sharding import ShardedEngine, make_mesh
    from lyra_tpu_torch.tools.conference import ConferenceBridge

    mesh = make_mesh(devices)
    if mesh.devices.size < n_devices:
        raise RuntimeError(f"need {n_devices} devices, have "
                           f"{mesh.devices.size}")
    mesh = make_mesh(mesh.devices[:n_devices])
    dev0 = mesh.devices[0]
    batch = 2 * n_devices

    def sharded(cls, **kw):
        return ShardedEngine(cls(16000, model_path, device=dev0, **kw), mesh)

    enc, dec = sharded(EncoderEngine), sharded(DecoderEngine)
    enc_state, dec_state = enc.init_state(batch), dec.init_state(batch)
    rng = np.random.RandomState(0)
    audio = rng.randint(-8000, 8000, (batch, 320)).astype(np.float32)
    received = np.ones((batch,), bool)
    received[::3] = False  # the PLC branch under sharding too
    stages = enc.rvq.num_stages
    bits = stages * config.BITS_PER_QUANTIZER

    indices, _, enc_state = enc.step(enc_state, audio, stages)
    wire = packet.pack_indices_batch(np.asarray(indices), bits)
    back = packet.unpack_indices_batch(wire, bits)
    out, _, dec_state = dec.step(dec_state, back, received)
    out = np.asarray(out)
    if out.shape != (batch, 320) or not np.isfinite(out).all():
        raise RuntimeError(f"sharded tick gave {out.shape}, finite "
                           f"{bool(np.isfinite(out).all())}")
    for state in (enc_state, dec_state):
        for k, part in enumerate(state.parts):
            away = [d for d in _leaf_devices(part, [])
                    if d != mesh.devices[k]]
            if away:
                raise RuntimeError(f"shard {k}'s state leaf escaped to "
                                   f"{away[0]}")

    # Conferencing on the mesh: shard-affine room placement feeds the
    # shard-local mixer, so the whole MCU tick (uplink decode → mix-minus-
    # one → downlink encode) runs with PCM sharded on the devices.
    bridge = ConferenceBridge(
        batch, dec_engine=sharded(DecoderEngine, emit_dtype="int16"),
        enc_engine=sharded(EncoderEngine))
    rooms_by_id = {i: i // 2 for i in range(batch)}
    bridge.add_participants(rooms_by_id,
                            slots=bridge.shard_affine_slots(rooms_by_id))
    pkts = np.zeros((batch, config.packet_size(64)), np.uint8)
    _, sizes = bridge.tick_wire(pkts, np.zeros(batch, bool))
    if sizes.shape != (batch,) or int(sizes.min()) <= 0:
        raise RuntimeError(f"bridge downlink sizes {sizes}")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("n_devices", type=int)
    p.add_argument("--model_path", default=config.DEFAULT_MODEL_PATH)
    args = p.parse_args(argv)
    dryrun_multichip(args.n_devices, model_path=args.model_path)
    print("dryrun ok")
    return 0


if __name__ == "__main__":
    sys.exit(main())
