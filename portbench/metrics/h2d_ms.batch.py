"""Server layer (``apps/serving.py:UInt8Server.clips``): device milliseconds of
host-to-device copies per request in the traced stretch, the frames' copy
above all.  Moves ``videos_per_s``."""

LAYER = "server: apps/serving.py UInt8Server"
UNIT = "ms"
MOVES = "videos_per_s"


def read(r):
    if r.profile is None or r.profile.htod_s <= 0 or not r.traced.get("requests"):
        return None
    return r.profile.htod_s / r.traced["requests"] * 1e3
