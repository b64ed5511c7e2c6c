"""The traced window: ``torch.profiler`` over a piece of work, reduced to
device intervals, the benchmark's own spans and the host's operations.

The pattern is the port's ``cli/perf.py`` (``kernel_device_ms``): host and
device activity in one profile, device time per kernel name.  The
benchmark's spans (``record_function('portbench.<what>')``) wrap its calls
into each layer; an idle gap of the device is named by the innermost such
span and the outermost host operation running at the gap's middle."""

from __future__ import annotations

import time
from collections import defaultdict

SPAN_PREFIX = "portbench."
# a kernel's name is cut to this many characters in the breakdown (a
# template's full name runs to a thousand)
NAME_CHARS = 160


class Trace:
    """``kernels``: ``[(name, start_ns, end_ns)]`` of every device
    operation (kernels, copies, sets); ``spans``: the benchmark's own spans
    ``[(name, start_ns, end_ns)]``; ``host_ops``: the host's operations
    ``[(name, start_ns, end_ns)]``; ``window_s``: the traced window's
    length on the host clock; ``start_ns``, ``end_ns``: its ends on the
    profiler's clock."""

    def __init__(self, kernels, spans, host_ops, window_s, start_ns, end_ns):
        self.kernels, self.spans, self.host_ops = kernels, spans, host_ops
        self.window_s, self.start_ns, self.end_ns = window_s, start_ns, end_ns

    def busy_intervals(self):
        """The device intervals merged where they overlap."""
        merged = []
        for _, s, e in sorted(self.kernels, key=lambda k: k[1]):
            if merged and s <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], e)
            else:
                merged.append([s, e])
        return merged

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def device_ms(self, match) -> tuple:
        """``(total ms, launches)`` of the device operations whose name
        contains ``match``."""
        hits = [e - s for name, s, e in self.kernels if match in name]
        return sum(hits) / 1e6, len(hits)

    def launches(self) -> int:
        return len(self.kernels)

    def device_ops(self, n: int = 10):
        """The ``n`` device operations that took most time, ``[[name, s]]``."""
        by = defaultdict(int)
        for name, s, e in self.kernels:
            by[name] += e - s
        top = sorted(by.items(), key=lambda kv: -kv[1])[:n]
        return [[name[:NAME_CHARS], ns / 1e9] for name, ns in top]

    def idle_gaps(self, n: int = 10):
        """The ``n`` longest device idle gaps in the window, each named by
        what the host was doing at its middle, ``[[name, s]]``."""
        busy = self.busy_intervals()
        edges = [self.start_ns] + [x for iv in busy for x in iv] + [self.end_ns]
        gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
                if edges[i + 1] > edges[i]]
        gaps.sort(key=lambda g: g[0] - g[1])
        return [[self.host_at((s + e) // 2), (e - s) / 1e9]
                for s, e in gaps[:n]]

    def host_at(self, t: int) -> str:
        """The innermost benchmark span and the outermost host operation
        around time ``t``."""
        span = [s for s in self.spans if s[1] <= t <= s[2]]
        span_name = (min(span, key=lambda s: s[2] - s[1])[0]
                     if span else "outside any span")
        ops = [o for o in self.host_ops if o[1] <= t <= o[2]]
        op = max(ops, key=lambda o: o[2] - o[1])[0] if ops else "python"
        return f"{span_name} / {op}"


def idle_percent(ctx):
    """The share of the traced window with no operation on the device,
    percent (the profiler's device intervals, merged, against the window's
    host-clock length); None where the run traced nothing.  Every
    ``device_idle.<kind>`` metric reads this."""
    tr = ctx.get("trace")
    if tr is None or not tr.kernels:
        return None
    return 100.0 * (1.0 - tr.busy_s() / tr.window_s)


def profile(fn):
    """Run ``fn()`` (which ends in a device synchronize) under
    ``torch.profiler`` with host and device activity; returns ``(fn's
    result, Trace)``."""
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile

    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        start_ns = time.time_ns()
        result = fn()
        torch.cuda.synchronize()
        end_ns = time.time_ns()
        window_s = time.perf_counter() - t0
    return result, reduce(prof, window_s, start_ns, end_ns)


def reduce(prof, window_s, start_ns, end_ns) -> Trace:
    """The profile as a :class:`Trace`.  The profiler's clock is aligned to
    the host's by the benchmark's outermost span, which the caller opens
    first."""
    kernels, spans, host_ops = [], [], []
    for ev in prof.profiler.kineto_results.events():
        name = ev.name()
        s = ev.start_ns()
        e = s + ev.duration_ns()
        if str(ev.device_type()).endswith("CUDA"):
            # a span's or the optimizer's annotation mirrored on the
            # device's timeline is no device work
            annotation = getattr(ev, "is_user_annotation", lambda: False)()
            if not (annotation or name.startswith(SPAN_PREFIX)
                    or name.startswith("Optimizer.")):
                kernels.append((name, s, e))
        elif name.startswith(SPAN_PREFIX):
            spans.append((name, s, e))
        elif name.startswith("aten::") or name.startswith("cuda"):
            host_ops.append((name, s, e))
    # keep only the outermost host operations (a nested one is part of it)
    host_ops.sort(key=lambda o: (o[1], -o[2]))
    outer, last_end = [], -1
    for op in host_ops:
        if op[1] >= last_end:
            outer.append(op)
            last_end = op[2]
    if spans:
        first = min(s[1] for s in spans)
        last = max(s[2] for s in spans)
    else:
        first, last = start_ns, end_ns
    return Trace(kernels, spans, outer, window_s, first, last)

