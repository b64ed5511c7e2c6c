"""Set-up: from the process's start to the first measured moment (imports,
the kernels' build or load, the program's objects, the cell's first
steps), host clock."""


def read(ctx):
    return ctx.get("setup_s")
