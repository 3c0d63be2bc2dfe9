"""Pooling of q, k and v (``ops/pooled_attention.py:pool_tokens``,
``eco.qkv_pool``): device milliseconds of the work launched inside the
spans of each pooled attention's class-token split, depthwise convs,
concats and norms, per request in the traced stretch: the passes over the
qkv rows that a pooled attention reading them by index would not make.
Moves ``videos_per_s``."""

LAYER = "pooled attention: ops/pooled_attention.py pooled_attention"
UNIT = "ms"
MOVES = "videos_per_s"


def read(r):
    span = r.spans.get("eco.qkv_pool")
    if not span or span["device_ms"] <= 0 or not r.traced.get("requests"):
        return None
    return span["device_ms"] / r.traced["requests"]
