"""The keyed draws, host milliseconds an update: the self time of the
program's ``ngx_torch.train.draw`` spans (the key splits, the kernel and
pool seeds, the chain's pool rows, the epochs' permutations) in the traced
block, over its updates (its ``ngx_torch.train.update`` spans)."""

from portbench.spans import recorded, self_ms


def read(ctx):
    draws = recorded(ctx, "ngx_torch.train.draw")
    updates = recorded(ctx, "ngx_torch.train.update")
    if not draws or not updates:
        return None
    spans = recorded(ctx)
    return sum(self_ms(s, spans) for s in draws) / len(updates)
