"""The whole train step's share of the card's float32 peak, percent: the
operations the step's algorithm needs (``yardstick.update_ops``: the acting
forward, GAE's value pass, every epoch's forward and backward of both
towers, the BC anchor; in the chain the stage policies' forwards of the
block spread over its updates) over one step's wall time in a plain block
(host clock, ending in a synchronize), against 67 TFLOP/s."""

from portbench.yardstick import F32_OPS_S


def read(ctx):
    if "update_ops" not in ctx:
        return None
    return 100.0 * ctx["update_ops"] / ctx["step_s"] / F32_OPS_S
