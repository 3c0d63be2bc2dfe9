"""Window attention core (``ops/attention.py:attention_core``, ``eco.attn``):
its least time, the larger of its operations (``COUNTS["attn.flops"]``:
twice the multiply-adds of q k^T and of the weights times v) at the card's
bf16 peak and its least bytes (``COUNTS["attn.bytes"]``: q, k and v read
once, the output written once, each call's gathered bias and mask read
once) at the card's memory rate, both from shapes, over the device time
launched inside ``eco.attn`` in the traced stretch, in percent.  Moves
``videos_per_s``."""

LAYER = "window attention: ops/attention.py window_attention"
UNIT = "%"
MOVES = "videos_per_s"


def read(r):
    flops, moved = r.counts.get("attn.flops", 0), r.counts.get("attn.bytes", 0)
    span = r.spans.get("eco.attn")
    if not flops or not span or span["device_ms"] <= 0:
        return None
    least = max(flops / r.peaks["bf16_flops_per_s"], moved / r.peaks["hbm_bytes_per_s"])
    return 100.0 * least / (span["device_ms"] * 1e-3)
