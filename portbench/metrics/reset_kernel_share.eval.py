"""Percent of the rows reset in the traced cycle that the program's reset
kernel reset: the ``kernel_envs`` counts of its ``ngx_torch.eval.reset``
spans over their ``envs`` counts.  It reads 0 where the spans carry no
``kernel_envs`` (a program whose resets are plain torch)."""

from portbench.spans import recorded


def read(ctx):
    resets = recorded(ctx, "ngx_torch.eval.reset")
    envs = sum(s.counts.get("envs", 0) for s in resets)
    if not envs:
        return None
    return 100.0 * sum(s.counts.get("kernel_envs", 0) for s in resets) / envs
