"""Host milliseconds of resets an evaluation step: the program's
``ngx_torch.eval.reset`` spans (the start reset and the done rows' resets)
over the ``steps`` counts of its ``ngx_torch.eval.run`` spans in the traced
cycle."""

from portbench.spans import recorded


def read(ctx):
    resets = recorded(ctx, "ngx_torch.eval.reset")
    steps = sum(s.counts["steps"] for s in recorded(ctx, "ngx_torch.eval.run"))
    if not resets or not steps:
        return None
    return sum(s.host_ms for s in resets) / steps
