"""The wrapper's milliseconds a call: the traced window over its calls,
minus the stepping kernel's device time a launch."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or "calls" not in ctx:
        return None
    ms, n = tr.device_ms("rollout_kernel")
    if n == 0:
        return None
    return 1e3 * tr.window_s / ctx["calls"] - ms / n
