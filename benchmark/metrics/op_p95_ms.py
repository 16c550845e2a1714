"""The 95th percentile (nearest rank) of every op's latency in the window:
host clock from the call to the synchronised read-back."""

import math


def read(run):
    lat = sorted(run.latencies_s)
    return 1e3 * lat[math.ceil(0.95 * len(lat)) - 1] if lat else None
