"""The device memory a training run holds at its peak: the caching
allocator's largest allocated total from set-up through the window, read
by the benchmark once the window has closed, in MiB."""


def read(ctx):
    if "step_ms" not in ctx or "memory_peak_bytes" not in ctx:
        return None
    return ctx["memory_peak_bytes"] / 2 ** 20
