"""Percent of the traced block in which the device is idle while the host
is inside the program's ``ngx_torch.train.draw`` spans (the keyed draws)."""

from portbench.spans import idle_in


def read(ctx):
    return idle_in(ctx, "ngx_torch.train.draw")
