"""Percent of the traced block in which the device is idle while the host
is inside the program's ``ngx_torch.train.update`` spans (autograd and
Adam over the minibatches)."""

from portbench.spans import idle_in


def read(ctx):
    return idle_in(ctx, "ngx_torch.train.update")
