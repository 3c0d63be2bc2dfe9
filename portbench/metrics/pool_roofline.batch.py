"""Pools (``ops/pool.py:pool_nd``: K4 for the 2D pools on the card, the
padded route for the 3D ones): their least time, each pool's input read
once and its output written once (``COUNTS["pool.bytes"]``, from shapes) at
the card's memory rate, over the device time launched inside the pooling
layers (``eco.layer.pooling``) in the traced stretch, in percent.  Moves
``videos_per_s``."""

LAYER = "pools: ops/pool.py pool_nd (K4 in 2D, the padded route in 3D)"
UNIT = "%"
MOVES = "videos_per_s"


def read(r):
    pooled = r.counts.get("pool.bytes", 0)
    span = r.spans.get("eco.layer.pooling")
    if not pooled or not span or span["device_ms"] <= 0:
        return None
    return 100.0 * pooled / r.peaks["hbm_bytes_per_s"] / (span["device_ms"] * 1e-3)
