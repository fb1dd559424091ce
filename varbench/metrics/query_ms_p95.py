"""query_ms_p95: the 95th percentile, in ms, of the latencies of all
requests completed in the window, each from the call to its numpy result
in hand (the host's clock)."""

import numpy as np


def read(record):
    lat = record["window"]["latency_s"]
    return float(np.percentile(lat, 95) * 1e3) if lat else None
