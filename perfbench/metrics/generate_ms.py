"""Device ms a frame of the `generate` layer (perfbench/layers/<config>.json
maps the trace's event names to it), over the traced stretch."""

LAYER = "generate"


def read(t):
    return t.layer_ms_per_step(LAYER) if t.has_layer(LAYER) else None
