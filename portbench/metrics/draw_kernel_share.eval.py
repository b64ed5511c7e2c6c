"""Percent of the steps evaluated in the traced cycle whose actions the
program's categorical kernel drew: the ``kernel_draws`` counts of its
``ngx_torch.eval.run`` spans over their ``steps`` counts.  It reads 0 where
the spans carry no ``kernel_draws`` (a program whose draws are plain
torch)."""

from portbench.spans import recorded


def read(ctx):
    runs = recorded(ctx, "ngx_torch.eval.run")
    steps = sum(s.counts.get("steps", 0) for s in runs)
    if not steps:
        return None
    return 100.0 * sum(s.counts.get("kernel_draws", 0) for s in runs) / steps
