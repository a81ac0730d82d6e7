"""Spans of the port's own layers, recorded in memory when asked for.

Tracing is off while `recorder` is None: `span(name)` then returns the
one shared null context, reads no clock and records nothing.
`recording()` installs a `Recorder` for a `with` block:

    from bn254_tpu_torch import obs

    with obs.recording(sync=torch.cuda.synchronize) as rec:
        api.batch_verify(messages, sigs, pks, mode="adaptive")
    for s in rec.spans:
        print("/".join(s.path + (s.name,)), s.seconds)

A span holds its name, the span it opened in (`parent`), the id of the
top-level span it lies under (one call of an entry point, one id) and its
start and end on `time.time_ns()`, the clock torch.profiler stamps device
events on. With `sync` (e.g. `torch.cuda.synchronize`) a span waits for
the card at each edge, so it times the work it encloses rather than its
enqueueing. With `on_span` each finished span goes to that callback
instead of `spans`. One thread records at a time.

The port opens spans at its layer boundaries only; README.md ("Tracing")
lists them and the counters kept beside them as module attributes
(`hash.tai_batch.host_fallbacks`, `kernels.fused.host_ns`, ...).
"""

from __future__ import annotations

import contextlib
import dataclasses
import itertools
import time


@dataclasses.dataclass
class Span:
    name: str
    parent: Span | None  # the span it opened in
    call_id: int  # shared by every span under one top-level span
    t0_ns: int  # time.time_ns()
    t1_ns: int = 0

    @property
    def path(self) -> tuple:
        """The names of the spans it lies in, outermost first."""
        names, s = [], self.parent
        while s is not None:
            names.append(s.name)
            s = s.parent
        return tuple(reversed(names))

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


class Recorder:
    """Opens and closes spans; keeps the finished ones in `spans` or hands
    each to `on_span`."""

    def __init__(self, sync=None, on_span=None):
        self.sync = sync
        self.on_span = on_span
        self.spans: list[Span] = []
        self._open: list[Span] = []
        self._ids = itertools.count()

    def open(self, name: str) -> Span:
        if self.sync is not None:
            self.sync()
        parent = self._open[-1] if self._open else None
        call_id = next(self._ids) if parent is None else parent.call_id
        s = Span(name, parent, call_id, time.time_ns())
        self._open.append(s)
        return s

    def close(self, s: Span) -> None:
        if self.sync is not None:
            self.sync()
        s.t1_ns = time.time_ns()
        self._open.pop()
        if self.on_span is None:
            self.spans.append(s)
        else:
            self.on_span(s)


class _Open:
    """The context of one span while a recorder is installed."""

    __slots__ = ("rec", "name", "span")

    def __init__(self, rec: Recorder, name: str):
        self.rec, self.name = rec, name

    def __enter__(self) -> Span:
        self.span = self.rec.open(self.name)
        return self.span

    def __exit__(self, *exc) -> bool:
        self.rec.close(self.span)
        return False


# the installed recorder; None: tracing is off
recorder: Recorder | None = None

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records the span `name` while a recorder is
    installed, and the shared null context otherwise."""
    rec = recorder
    return _OFF if rec is None else _Open(rec, name)


@contextlib.contextmanager
def recording(sync=None, on_span=None):
    """Install a Recorder for the `with` block and yield it; the one
    installed before is restored on exit."""
    global recorder
    saved, recorder = recorder, Recorder(sync, on_span)
    try:
        yield recorder
    finally:
        recorder = saved
