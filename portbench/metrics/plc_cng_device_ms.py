"""Device ms per tick of the decoder's loss concealment and comfort noise:
the `dec.plc`, `dec.cng`, `dec.crossfade` and `dec.noise` marker
segments (codec/engine.py: the feature estimator, the PLC state and
gates, comfort noise, the crossfade, the noise estimator), over the
traced stretch (portbench/traced.py)."""

from portbench import traced


def read(ctx):
    return traced.device_ms(ctx, "dec.plc", "dec.cng", "dec.crossfade",
                            "dec.noise")
