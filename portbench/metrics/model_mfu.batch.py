"""Model step (``runtime/executor.py:Program.apply`` over the folded graph):
model FLOPs of the videos scored in the traced stretch (twice the
multiply-adds of every conv and fc, from the configuration's shapes) over
the seconds in which the device ran the model's work, at the card's bf16
peak, in percent.  The model's work is everything on the device but copies
and the preprocessing kernel K1: the union of the rest's intervals, so
host gaps between kernels do not count.  Moves ``videos_per_s``."""

LAYER = "model step: runtime/executor.py Program.apply"
UNIT = "%"
MOVES = "videos_per_s"
NOT_MODEL = ("Memcpy", "crop_normalize")


def read(r):
    if r.profile is None or not r.traced.get("videos"):
        return None
    seconds = r.profile.busy_without(NOT_MODEL)
    if seconds <= 0:
        return None
    flops = r.flops_per_video * r.traced["videos"]
    return 100.0 * flops / (seconds * r.peaks["bf16_flops_per_s"])
