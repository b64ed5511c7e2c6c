"""The acting phase, milliseconds an update on the device's timeline: the
CUDA events of the program's ``ngx_torch.train.acting`` spans (the acting
kernel in ``make_train``, ``act`` in the chain) in the traced block."""

from portbench.spans import device_ms_each


def read(ctx):
    return device_ms_each(ctx, "ngx_torch.train.acting")
