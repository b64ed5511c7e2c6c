"""The program's own spans in a traced run: those ``ngx_torch.utils.trace``
recorded in the latest profiler session, kept where they lie inside the
traced window (``ctx['trace']``'s ``[start_ns, end_ns]``, both on the
profiler's clock, which the recorder stamps too).

A program without the recorder, or a run that traced nothing, gives no
spans, and every reader of them then returns None."""

from __future__ import annotations


def recorded(ctx, name=None) -> list:
    """The recorded spans (named ``name``, where given) inside the traced
    window, in the order they opened; [] without a trace or a recorder."""
    tr = ctx.get("trace")
    if tr is None:
        return []
    try:
        from ngx_torch.utils import trace
    except ImportError:
        return []
    return [s for s in trace.spans()
            if (name is None or s.name == name)
            and tr.start_ns <= s.start_ns and s.end_ns <= tr.end_ns]


def union(intervals) -> list:
    """``[[start, end]]`` merged where they overlap, in order."""
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return merged


def covered_ns(intervals, within) -> int:
    """Nanoseconds of the merged ``intervals`` inside the merged
    ``within``."""
    a, b = union(intervals), union(within)
    total = i = j = 0
    while i < len(a) and j < len(b):
        lo, hi = max(a[i][0], b[j][0]), min(a[i][1], b[j][1])
        total += max(0, hi - lo)
        if a[i][1] < b[j][1]:
            i += 1
        else:
            j += 1
    return total


def idle_gaps(tr) -> list:
    """The device's idle intervals inside the traced window."""
    edges = ([tr.start_ns] + [x for iv in tr.busy_intervals() for x in iv]
             + [tr.end_ns])
    return [[max(s, tr.start_ns), min(e, tr.end_ns)]
            for s, e in zip(edges[0::2], edges[1::2])
            if min(e, tr.end_ns) > max(s, tr.start_ns)]


def idle_in(ctx, name):
    """Percent of the traced window in which the device is idle while the
    host is inside a span ``name``; None without such spans."""
    spans = recorded(ctx, name)
    if not spans:
        return None
    tr = ctx["trace"]
    idle = covered_ns(idle_gaps(tr), [[s.start_ns, s.end_ns] for s in spans])
    return 100.0 * idle / (tr.end_ns - tr.start_ns)


def self_ms(span, spans) -> float:
    """``span``'s host milliseconds less the part its children among
    ``spans`` cover."""
    children = [[c.start_ns, c.end_ns] for c in spans if c.parent is span]
    return (span.end_ns - span.start_ns
            - covered_ns(children, [[span.start_ns, span.end_ns]])) / 1e6


def device_ms_each(ctx, name):
    """The mean device-timeline milliseconds of the spans ``name``; None
    without such spans or without their device times."""
    spans = recorded(ctx, name)
    ms = [s.device_ms() for s in spans]
    if not ms or any(m is None for m in ms):
        return None
    return sum(ms) / len(ms)
