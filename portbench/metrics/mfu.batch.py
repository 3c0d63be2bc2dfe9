"""Server layer (``apps/serving.py:UInt8Server``), the whole request: model
FLOPs of the videos scored in the host-timed stretch (twice the
multiply-adds of every conv and fc, from the configuration's shapes) over
the stretch's seconds at the card's bf16 peak, in percent.  The stretch
holds everything a request costs: the frames' copy, K1, the model, the
copy of the probabilities and the host between them; so this is the whole
step's share of the peak, which bounds every kernel's.  Moves
``videos_per_s``."""

LAYER = "server: apps/serving.py UInt8Server"
UNIT = "%"
MOVES = "videos_per_s"


def read(r):
    if not r.host.get("videos") or r.host["seconds"] <= 0:
        return None
    flops = r.flops_per_video * r.host["videos"]
    return 100.0 * flops / (r.host["seconds"] * r.peaks["bf16_flops_per_s"])
