"""The 90th percentile (nearest rank) of one update's wall time over every
update of the traced run's window: CUDA events recorded after each update,
read after the window."""

import math


def read(ctx):
    ms = sorted(ctx.get("step_ms") or [])
    if not ms:
        return None
    return ms[math.ceil(0.9 * len(ms)) - 1]
