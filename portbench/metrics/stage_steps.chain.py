"""Steps of stage play a refresh: the ``steps`` counts of the program's
``ngx_torch.chain.stage`` spans, summed over the stages, over the traced
block's refreshes (its ``ngx_torch.train.refresh`` spans).  Stage play
stops once every env is frozen, so the count follows the key."""

from portbench.spans import recorded


def read(ctx):
    stages = recorded(ctx, "ngx_torch.chain.stage")
    refreshes = recorded(ctx, "ngx_torch.train.refresh")
    if not stages or not refreshes:
        return None
    return sum(s.counts["steps"] for s in stages) / len(refreshes)
