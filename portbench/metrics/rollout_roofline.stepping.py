"""The stepping kernel's share of its roofline, percent: the least time of
a launch (``yardstick.kernel_bound_ms``, bytes) over its device time a
launch in the traced calls (``torch.profiler``)."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or "calls" not in ctx:
        return None
    ms, n = tr.device_ms("rollout_kernel")
    if n == 0 or ms <= 0:
        return None
    return 100.0 * ctx["kernel_bound_ms"] / (ms / n)
