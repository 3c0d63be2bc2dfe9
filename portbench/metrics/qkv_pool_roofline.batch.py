"""Pooling of q, k and v (``ops/pooled_attention.py:pool_qkv``,
``eco.qkv_pool``): its least time, its least bytes
(``COUNTS["qkv_pool.bytes"]``: for each of q, k and v, each qkv row some
window reads and the class token's row read once, each output row written
once, from shapes, whichever route runs) at the card's memory rate, over
the device time launched inside ``eco.qkv_pool`` in the traced stretch, in
percent.  Moves ``videos_per_s``."""

LAYER = "pooled attention: ops/pooled_attention.py pooled_attention"
UNIT = "%"
MOVES = "videos_per_s"


def read(r):
    moved = r.counts.get("qkv_pool.bytes", 0)
    span = r.spans.get("eco.qkv_pool")
    if not moved or not span or span["device_ms"] <= 0:
        return None
    return 100.0 * (moved / r.peaks["hbm_bytes_per_s"]) / (span["device_ms"] * 1e-3)
