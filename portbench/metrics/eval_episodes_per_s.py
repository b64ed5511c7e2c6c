"""Episodes evaluated over the window's wall time (host clock; each
evaluation returns its metrics to the host)."""


def read(ctx):
    if "episodes" not in ctx:
        return None
    return ctx["episodes"] / ctx["window_s"]
