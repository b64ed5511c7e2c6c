"""Device-to-host reads an evaluation: the ``host_reads`` counts of the
program's ``ngx_torch.eval.run`` spans (a ``bool`` a step, the four
metrics' ``float``) over those spans in the traced cycle."""

from portbench.spans import recorded


def read(ctx):
    runs = recorded(ctx, "ngx_torch.eval.run")
    if not runs:
        return None
    return sum(s.counts["host_reads"] for s in runs) / len(runs)
