"""Server layer (``apps/serving.py:UInt8Server.__call__``): device operations
(kernels, copies, fills) launched inside the program's ``eco.serve`` span
per request in the traced stretch, by the profiler's link of each to the
host op that launched it.  Each launch costs the host its enqueue, which
bounds a request where the device waits for the host (ECO-Full, PERF.md
§5).  Moves ``videos_per_s``."""

LAYER = "server: apps/serving.py UInt8Server"
UNIT = "launches"
MOVES = "videos_per_s"


def read(r):
    serve = r.spans.get("eco.serve")
    if not serve or not serve["launches"] or not r.traced.get("requests"):
        return None
    return serve["launches"] / r.traced["requests"]
