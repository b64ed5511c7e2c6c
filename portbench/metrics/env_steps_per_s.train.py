"""B x T x the updates completed, over the traced run's window of wall
time, which ends in a device synchronize (host clock)."""


def read(ctx):
    if "step_ms" not in ctx:
        return None
    return ctx["env_steps"] / ctx["window_s"]
