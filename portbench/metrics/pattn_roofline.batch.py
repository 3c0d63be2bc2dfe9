"""Pooled attention core (``ops/pooled_attention.py:pooled_attention``,
``eco.pattn``): its least time, the larger of its operations
(``COUNTS["pattn.flops"]``: twice the multiply-adds of q k^T, of the
weights times v and of the three relative-position products) at the card's
bf16 peak and its least bytes (``COUNTS["pattn.bytes"]``: q, k and v read
once, the output written once, the three position tables read once; not
the bias the route materialises) at the card's memory rate, both from
shapes, over the device time launched inside ``eco.pattn`` in the traced
stretch, in percent.  Moves ``videos_per_s``."""

LAYER = "pooled attention: ops/pooled_attention.py pooled_attention"
UNIT = "%"
MOVES = "videos_per_s"


def read(r):
    flops, moved = r.counts.get("pattn.flops", 0), r.counts.get("pattn.bytes", 0)
    span = r.spans.get("eco.pattn")
    if not flops or not span or span["device_ms"] <= 0:
        return None
    least = max(flops / r.peaks["bf16_flops_per_s"], moved / r.peaks["hbm_bytes_per_s"])
    return 100.0 * least / (span["device_ms"] * 1e-3)
