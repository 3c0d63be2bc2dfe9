"""Device (the H100): the share of the traced stretch in which no kernel,
copy or fill ran on the card, in percent.  Moves ``videos_per_s``."""

LAYER = "device: H100"
UNIT = "%"
MOVES = "videos_per_s"


def read(r):
    if r.profile is None or r.profile.busy_s <= 0:
        return None
    return 100.0 * (1.0 - r.profile.busy_s / r.profile.window_s)
