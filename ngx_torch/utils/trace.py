"""The program's spans and counts, on ``torch.profiler``'s clock.

A span is a named interval of the program, ``ngx_torch.<layer>.<what>``,
with the span open around it (its parent), its host start and end in
epoch nanoseconds (``time.time_ns()``, the clock of the profiler's kineto
events, so a span lines up with the profile's device intervals; each the
midpoint of the two reads round the profiler's own stamp), its
device-timeline duration (a pair of CUDA events recorded on the current
stream at its start and end, resolved only when asked, after the caller's
synchronize; none where CUDA is not in use) and its counts (steps played,
host reads, envs reset), set before it ends.  While it is recorded a span
is also a ``torch.profiler.record_function``, so it shows in any profile,
a chrome trace included (the device timeline mirrors it as a user
annotation, which is no device work).

Spans are recorded only while a ``torch.profiler`` session is active
(``torch.autograd.profiler._is_profiler_enabled``), and the recorder keeps
those of the latest session.  Outside a session a span costs one test of
that flag: no ``record_function``, no event, no clock read, no allocation.

:class:`Phases` opens the top-level spans of a train step end to end, and
is the one synchronizing read-out: with ``train_step.phases`` a dict each
phase synchronizes the device at its end and appends its host-clock
seconds to ``phases[<what>]``.
"""

from __future__ import annotations

import time

import torch
from torch.autograd import profiler as _profiler


class Span:
    """One recorded span: ``name``, ``parent`` (the :class:`Span` open
    around it, or None), ``start_ns`` and ``end_ns`` (epoch nanoseconds on
    the host), ``counts`` (``{name: int}``) and, through
    :meth:`device_ms`, its device-timeline milliseconds."""

    __slots__ = ("name", "parent", "start_ns", "end_ns", "counts", "_device")

    def __init__(self, name, parent=None, start_ns=0, end_ns=0, counts=None,
                 device=None):
        self.name, self.parent = name, parent
        self.start_ns, self.end_ns = start_ns, end_ns
        self.counts = {} if counts is None else counts
        # None, the milliseconds, or the (start, end) CUDA events
        self._device = device

    @property
    def host_ms(self) -> float:
        return (self.end_ns - self.start_ns) / 1e6

    def device_ms(self):
        """Milliseconds between the span's CUDA events on the device's
        timeline, None where it recorded none.  The events must have
        completed: read after a device synchronize."""
        if isinstance(self._device, tuple):
            start, end = self._device
            self._device = start.elapsed_time(end)
        return self._device


class _Off:
    """The span outside a profiler session: does nothing."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def count(self, name, value):
        pass


_OFF = _Off()


class _Recording:
    """A span being recorded: a context manager that opens the
    :class:`Span` and its ``record_function`` and closes them."""

    __slots__ = ("recorder", "span", "_events", "_rf")

    def __init__(self, recorder, name):
        self.recorder, self.span = recorder, Span(name)

    def __enter__(self):
        rec, span = self.recorder, self.span
        rec._enter(span)
        self._events = None
        if torch.cuda.is_initialized():
            self._events = (torch.cuda.Event(enable_timing=True),
                            torch.cuda.Event(enable_timing=True))
            self._events[0].record()
        self._rf = _profiler.record_function(span.name)
        # the profiler stamps the span inside __enter__: between these reads
        before = time.time_ns()
        self._rf.__enter__()
        span.start_ns = (before + time.time_ns()) // 2
        return self

    def __exit__(self, *exc):
        before = time.time_ns()
        self._rf.__exit__(*exc)
        span = self.span
        span.end_ns = (before + time.time_ns()) // 2
        if self._events is not None:
            self._events[1].record()
            span._device = self._events
        self.recorder._open.pop()
        return False

    def count(self, name, value):
        """Set the count ``name`` of the span to ``value``."""
        self.span.counts[name] = int(value)


class Recorder:
    """The spans of the latest profiler session (``spans``, in the order
    they opened) and the stack of those open now."""

    def __init__(self):
        self.spans = []
        self._open = []
        # a span was asked for outside a session since the last recorded:
        # the next recorded one starts a new session
        self._between = True

    def span(self, name: str):
        """A context manager for the span ``name``; ``.count(name, value)``
        on what it returns sets a count.  Recorded only inside a profiler
        session."""
        if not _profiler._is_profiler_enabled:
            self._between = True
            return _OFF
        return _Recording(self, name)

    def _enter(self, span):
        if self._between and not self._open:
            self.spans = []
        self._between = False
        span.parent = self._open[-1] if self._open else None
        self._open.append(span)
        self.spans.append(span)


RECORDER = Recorder()


def span(name: str):
    """:meth:`Recorder.span` of the program's recorder."""
    return RECORDER.span(name)


def spans() -> list:
    """The recorded spans of the latest profiler session, in the order they
    opened."""
    return list(RECORDER.spans)


class Phases:
    """The top-level spans of one train step, end to end: ``phase(name)``
    ends the open phase and opens the span ``name``
    (``ngx_torch.<layer>.<what>``); leaving the ``with`` block ends the
    last.  So the phases tile the step.

    ``phases``: ``train_step.phases``.  None records the spans alone
    (inside a profiler session).  A dict also times each phase, as a
    synchronizing read-out: each phase ends in a synchronize of
    ``device`` (the first also starts after one) and appends its host-clock
    seconds under ``<what>`` (the synchronizes cost a little)."""

    def __init__(self, phases, device):
        self.phases, self.device = phases, device
        self._name = self._span = None
        self._t = 0.0

    def __enter__(self):
        return self

    def __call__(self, name: str):
        self._end(None)
        if self.phases is not None:
            if self._name is None:
                self._t = self._sync()
            self._name = name
        self._span = RECORDER.span(name)
        self._span.__enter__()

    def __exit__(self, *exc):
        self._end(exc)
        return False

    def _end(self, exc):
        if self._span is not None:
            self._span.__exit__(*(exc or (None, None, None)))
            self._span = None
        if self.phases is not None and self._name is not None and not (
                exc and exc[0] is not None):
            now = self._sync()
            what = self._name[self._name.rfind(".") + 1:]
            self.phases.setdefault(what, []).append(now - self._t)
            self._t = now

    def _sync(self) -> float:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
        return time.perf_counter()
