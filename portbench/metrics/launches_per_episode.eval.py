"""Device operations launched (kernels, copies, sets) in the traced
evaluations, one whole cycle of the pool, per episode evaluated."""


def read(ctx):
    tr = ctx.get("trace")
    if tr is None or "episodes_traced" not in ctx:
        return None
    return tr.launches() / ctx["episodes_traced"]
