"""B x T x the calls completed, over the window's wall time, which ends in
a device synchronize (host clock)."""


def read(ctx):
    if "env_steps" not in ctx or "step_ms" in ctx:
        return None
    return ctx["env_steps"] / ctx["window_s"]
