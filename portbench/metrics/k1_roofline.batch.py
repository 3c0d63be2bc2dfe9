"""Preprocess kernel K1 (``ops/preprocess.py``, ``csrc/preprocess.cu``): its
least time, the crop windows read once and the bf16 clips written once at
the card's memory rate, over its device time per launch, in percent.
Moves ``videos_per_s``."""

LAYER = "preprocess kernel K1: ops/preprocess.py, csrc/preprocess.cu"
UNIT = "%"
MOVES = "videos_per_s"


def read(r):
    if r.profile is None or not r.traced.get("videos"):
        return None
    seconds, launches = r.profile.kernel_time("crop_normalize")
    if launches == 0 or seconds <= 0:
        return None
    bound = r.k1_bytes_per_video * r.traced["videos"] / r.peaks["hbm_bytes_per_s"]
    return 100.0 * bound / seconds
