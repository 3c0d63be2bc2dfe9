"""Conv epilogue (``ops/conv.py`` and ``ops/linear.py``: the bias add,
``eco.bias``; ``ops/elementwise.py``: the ReLU layers, ``eco.layer.relu``):
device milliseconds of the work launched inside those spans per request in
the traced stretch.  Separate passes over every conv's output today, the
largest block of a request after the convs themselves; a fused epilogue
takes them off.  Moves ``videos_per_s``."""

LAYER = "conv epilogue: ops/conv.py bias add, ops/elementwise.py relu"
UNIT = "ms"
MOVES = "videos_per_s"
SPANS = ("eco.bias", "eco.layer.relu")


def read(r):
    ms = sum(r.spans[s]["device_ms"] for s in SPANS if s in r.spans)
    if ms <= 0 or not r.traced.get("requests"):
        return None
    return ms / r.traced["requests"]
