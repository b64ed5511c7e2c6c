"""The learner's recompute of logp and the value, milliseconds an update on
the device's timeline: the CUDA events of the program's
``ngx_torch.train.recompute`` spans (``make_learner``) in the traced
block."""

from portbench.spans import device_ms_each


def read(ctx):
    return device_ms_each(ctx, "ngx_torch.train.recompute")
