"""Spans, counters and launch records taken from outside the program, and
the reduction of a device trace.

In a traced run the harness wraps named module attributes of the port
("module:attr") so that each call into a layer is a span: the card is
synchronised on entry and exit (in the window; not under the profiler, see
harness.py), and the host clock read. A name that the
port no longer has is skipped, and the metrics that read it stay silent.
Nothing is wrapped in an untraced run.
"""

from __future__ import annotations

import dataclasses
import functools
import importlib
import time


@dataclasses.dataclass
class Span:
    name: str
    path: tuple  # the names of the spans it lies in, outermost first
    t0_ns: int  # wall clock (time.time_ns), as the profiler's timestamps
    t1_ns: int

    @property
    def seconds(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9


@dataclasses.dataclass
class Call:
    """One call of the timed path."""

    index: int
    t0: float  # perf_counter
    t1: float
    t0_ns: int  # wall clock
    t1_ns: int
    verdict: object = None
    spans: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)
    launches: list = dataclasses.field(default_factory=list)  # (key, lanes)
    fell_back: bool = False  # the independent tier ran

    @property
    def seconds(self) -> float:
        return self.t1 - self.t0


def resolve(target: str):
    """(module, attribute name) of "module:attr", or None if either is
    missing."""
    mod_name, attr = target.split(":")
    try:
        mod = importlib.import_module(mod_name)
    except ImportError:
        return None
    return (mod, attr) if hasattr(mod, attr) else None


def counter_value(target: str):
    """The value of a counter attribute: an int, or the sum of a dict of
    ints; None if it is missing."""
    found = resolve(target)
    if found is None:
        return None
    v = getattr(*found)
    return sum(v.values()) if isinstance(v, dict) else int(v)


class Tracer:
    """Wraps attributes for the length of a traced run; `call` is the Call
    that spans and launches go to."""

    def __init__(self, sync):
        self.sync = sync
        self.call: Call | None = None
        self._stack: list[str] = []
        self._saved: list = []
        self.missing: list[str] = []

    def patch(self, target: str, make):
        """Replace "module:attr" by make(original); False if missing."""
        found = resolve(target)
        if found is None:
            self.missing.append(target)
            return False
        mod, attr = found
        orig = getattr(mod, attr)
        self._saved.append((mod, attr, orig))
        setattr(mod, attr, make(orig))
        return True

    def span(self, name: str, target: str) -> bool:
        def make(orig):
            @functools.wraps(orig)
            def wrapper(*args, **kwargs):
                self.sync()
                path = tuple(self._stack)
                self._stack.append(name)
                t0 = time.time_ns()
                try:
                    return orig(*args, **kwargs)
                finally:
                    self.sync()
                    t1 = time.time_ns()
                    self._stack.pop()
                    if self.call is not None:
                        self.call.spans.append(Span(name, path, t0, t1))
            return wrapper

        return self.patch(target, make)

    def launch(self, key: str, lanes: int) -> None:
        if self.call is not None:
            self.call.launches.append((key, lanes))

    def restore(self) -> None:
        for mod, attr, orig in reversed(self._saved):
            setattr(mod, attr, orig)
        self._saved.clear()


# -- per-call span arithmetic --------------------------------------------


def span_seconds(call: Call, names, outside=()) -> float | None:
    """Seconds of the call in outermost spans named in `names` that lie in
    no span named in `outside`; None if there is none."""
    names = set(names)
    found = [s for s in call.spans
             if s.name in names and not names.intersection(s.path)
             and not set(outside).intersection(s.path)]
    if not found:
        return None
    return sum(s.seconds for s in found)


# -- the device trace -----------------------------------------------------



@dataclasses.dataclass
class DeviceTrace:
    """The device operations of the profiled calls and the window that
    holds them, on the wall clock in ns."""

    ops: list  # (name, start_ns, end_ns)
    t0_ns: int
    t1_ns: int

    @property
    def window_s(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-9

    def busy_intervals(self) -> list:
        """The union of the operations' intervals inside the window."""
        merged = []
        for _, a, b in sorted(self.ops, key=lambda o: o[1]):
            a, b = max(a, self.t0_ns), min(b, self.t1_ns)
            if b <= a:
                continue
            if merged and a <= merged[-1][1]:
                merged[-1][1] = max(merged[-1][1], b)
            else:
                merged.append([a, b])
        return merged

    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) * 1e-9

    def idle_gaps(self) -> list:
        """(start_ns, end_ns) of every stretch in which nothing ran."""
        gaps, t = [], self.t0_ns
        for a, b in self.busy_intervals():
            if a > t:
                gaps.append((t, a))
            t = max(t, b)
        if self.t1_ns > t:
            gaps.append((t, self.t1_ns))
        return gaps

    def op_seconds(self) -> dict:
        """Device seconds by operation name."""
        out: dict = {}
        for name, a, b in self.ops:
            out[name] = out.get(name, 0.0) + (b - a) * 1e-9
        return out


def from_profiler(prof, t0_ns: int, t1_ns: int) -> DeviceTrace:
    """The device operations (kernels, copies, fills) of a finished
    torch.profiler run that traced the device alone."""
    from torch.autograd import DeviceType

    ops = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns())
           for e in prof.profiler.kineto_results.events()
           if e.device_type() == DeviceType.CUDA]
    return DeviceTrace(ops, t0_ns, t1_ns)


def idle_by_span(trace: DeviceTrace, calls) -> dict:
    """Idle seconds of the window by what the host was in at each gap's
    middle: the innermost span, named with the spans it lies in
    ("fallback/final_exp"), "call" inside a call outside every span, or
    "between calls"."""
    spans = [s for c in calls for s in c.spans]
    bounds = [(c.t0_ns, c.t1_ns) for c in calls]
    out: dict = {}
    for a, b in trace.idle_gaps():
        mid = (a + b) // 2
        inner = [s for s in spans if s.t0_ns <= mid < s.t1_ns]
        if inner:
            span = max(inner, key=lambda s: len(s.path))
            name = "/".join(span.path + (span.name,))
        elif any(c0 <= mid < c1 for c0, c1 in bounds):
            name = "call"
        else:
            name = "between calls"
        out[name] = out.get(name, 0.0) + (b - a) * 1e-9
    return out
