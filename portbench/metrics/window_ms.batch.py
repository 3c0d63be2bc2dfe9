"""Window layout (``ops/attention.py``, ``eco.window``): device milliseconds
of the work launched inside the spans of the windowed attention's copies
(each pad, shift and partition, and each reverse, unshift and crop) per
request in the traced stretch: the passes over the activations that a
fused window attention would not make.  Moves ``videos_per_s``."""

LAYER = "window attention: ops/attention.py window_attention"
UNIT = "ms"
MOVES = "videos_per_s"


def read(r):
    span = r.spans.get("eco.window")
    if not span or span["device_ms"] <= 0 or not r.traced.get("requests"):
        return None
    return span["device_ms"] / r.traced["requests"]
