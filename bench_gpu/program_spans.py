"""The port's own spans and counters (`bn254_tpu_torch.obs`) in a traced
run.

`install(tracer)` puts one `obs.Recorder` in `bn254_tpu_torch.obs:recorder`
through `tracer.patch`, so that `tracer.restore()` takes it out again; a
second call for the same tracer does nothing. The program's spans then
synchronise the card through the tracer's `sync` at each edge (in the
window; not under the profiler, where harness.py swaps `sync` out), and
each finished span goes into the current call as a `tracing.Span` whose
path is the harness's open spans followed by the program's
("points/verify/fused/points" for `points.tree_sum`). While the recorder is
installed `fused_op` also sums its host time (`kernels.fused:host_ns`).

A port without `obs` gets nothing installed; the readers of its spans and
of `host_ns` then stay silent.
"""

from __future__ import annotations

from bench_gpu import tracing as TR

TARGET = "bn254_tpu_torch.obs:recorder"


def install(tracer: TR.Tracer) -> None:
    if TARGET in tracer.missing or any(
            f"{mod.__name__}:{attr}" == TARGET
            for mod, attr, _ in tracer._saved):
        return
    found = TR.resolve(TARGET)
    if found is None:
        tracer.missing.append(TARGET)
        return
    obs = found[0]

    def forward(span) -> None:
        if tracer.call is not None:
            tracer.call.spans.append(TR.Span(
                span.name, tuple(tracer._stack) + span.path, span.t0_ns,
                span.t1_ns))

    tracer.patch(TARGET, lambda _: obs.Recorder(
        sync=lambda: tracer.sync(), on_span=forward))


def span_ms(run, names, outside=()):
    """The median over the window's calls of a call's ms in the spans
    `names` (outermost, outside `outside`); None if no call has one."""
    s = run.per_call(lambda c: TR.span_seconds(c, names, outside))
    return None if s is None else s * 1e3
