"""The pool draw, host milliseconds an update: the host time of the
program's ``ngx_torch.train.pool_draw`` spans (``draw_pool``: the launch
wrapper of ``pool_reset``'s B x R counter resets, the kernel itself runs
asynchronously) in the traced block, over its updates (its
``ngx_torch.train.update`` spans).  None where no span carries ``rows``: a
native-mode trainer, or a program without the span."""

from portbench.spans import recorded


def read(ctx):
    draws = [s for s in recorded(ctx, "ngx_torch.train.pool_draw")
             if "rows" in s.counts]
    updates = recorded(ctx, "ngx_torch.train.update")
    if not draws or not updates:
        return None
    return sum(s.host_ms for s in draws) / len(updates)
