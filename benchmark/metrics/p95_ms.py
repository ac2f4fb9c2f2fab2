"""p95_ms: the 95th percentile of the latency of every request completed in
the window, from the call to the returned waves (host clock)."""

import numpy as np


def read(run):
    lat = run.window.get("latencies_ms")
    return float(np.percentile(lat, 95)) if lat else None
