"""The 95th percentile (nearest rank), over every answer of the window,
of the seconds from its batch's frames going to batched_encode to
generate_tokens' tokens on the host."""

import math


def read(run):
    lat = sorted(r["latency_s"] for r in run.records if r["kind"] == "qa"
                 for _ in range(r["answers"]))
    if not lat:
        return None
    return lat[math.ceil(0.95 * len(lat)) - 1]
