"""Host milliseconds a step of stage play: the program's
``ngx_torch.chain.stage`` spans' host time over their ``steps`` counts,
the cost of stage play whatever the key's step count."""

from portbench.spans import recorded


def read(ctx):
    stages = recorded(ctx, "ngx_torch.chain.stage")
    steps = sum(s.counts["steps"] for s in stages)
    if not steps:
        return None
    return sum(s.host_ms for s in stages) / steps
