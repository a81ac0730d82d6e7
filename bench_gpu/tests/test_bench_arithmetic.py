"""The metric arithmetic on synthetic calls, spans and device events."""

import io

import pytest

from bench_gpu import spec
from bench_gpu import tracing as TR
from bench_gpu.harness import Run


def call(i, t0, t1, spans=(), launches=(), counters=None):
    c = TR.Call(i, t0, t1, int(t0 * 1e9), int(t1 * 1e9))
    c.spans = [TR.Span(n, p, int(a * 1e9), int(b * 1e9))
               for n, p, a, b in spans]
    c.launches = list(launches)
    c.counters = counters or {}
    return c


def make_run(calls, profiled=(), trace=None):
    run = Run(tuples=100)
    run.calls, run.profiled, run.trace = list(calls), list(profiled), trace
    run.log = io.StringIO()
    return run


def test_rate_is_all_tuples_over_first_start_to_last_end():
    run = make_run([call(0, 10.0, 11.0), call(1, 11.0, 12.5),
                    call(2, 12.5, 14.0)])
    assert spec.reader("verifies_per_s").read(run) == pytest.approx(300 / 4)


def test_spans_count_the_outermost_and_leave_out_the_fallback():
    c = call(0, 0, 10, spans=[
        ("hash", (), 0.0, 1.0),
        ("hash", ("hash",), 0.2, 0.5),  # nested: counted once
        ("final_exp", (), 5.0, 6.5),
        ("final_exp", (), 6.5, 7.0),  # is_one after final_exp
        ("fallback", (), 7.0, 9.0),
        ("final_exp", ("fallback",), 7.5, 8.5)])
    assert TR.span_seconds(c, ["hash"]) == pytest.approx(1.0)
    assert TR.span_seconds(c, ["final_exp"], outside=["fallback"]) == \
        pytest.approx(2.0)
    assert TR.span_seconds(c, ["miller"]) is None
    run = make_run([c, c, c])
    assert spec.reader("final_exp_ms").read(run) == pytest.approx(2000.0)
    assert spec.reader("fallback_ms").read(run) == pytest.approx(2000.0)
    assert spec.reader("miller_ms").read(run) is None


def test_busy_time_is_the_union_of_intervals_inside_the_window():
    ops = [("a", 0, 10), ("b", 5, 20), ("c", 30, 40), ("d", 35, 38),
           ("e", 90, 120)]
    t = TR.DeviceTrace(ops, 0, 100)
    assert t.busy_intervals() == [[0, 20], [30, 40], [90, 100]]
    assert t.busy_s() == pytest.approx(40e-9)
    assert t.idle_gaps() == [(20, 30), (40, 90)]
    run = make_run([], trace=t)
    assert spec.reader("device_idle_share").read(run) == pytest.approx(60.0)
    assert t.op_seconds()["e"] == pytest.approx(30e-9)


def test_idle_gaps_are_named_by_the_innermost_span():
    c = call(0, 0.0, 1.0, spans=[("points", (), 0.0, 0.5),
                                 ("hash", ("points",), 0.1, 0.2)])
    t = TR.DeviceTrace([("k", 0, int(0.1e9)), ("k", int(0.2e9), int(0.6e9)),
                        ("k", int(0.95e9), int(1.0e9))], 0, int(1.2e9))
    idle = TR.idle_by_span(t, [c])
    assert idle == pytest.approx({"points/hash": 0.1, "call": 0.35,
                                  "between calls": 0.2})


def test_roofline_is_least_time_over_device_time():
    work = spec.kernel_work()
    peaks = spec.peaks()
    roof = spec.reader("kernels_roofline")
    lanes = 8193
    w = work["miller_dbl_body"]
    least = roof.least_seconds(w, lanes, peaks)
    ops = w["products_per_lane"] * 648 * lanes / 16.75e12
    assert least == pytest.approx(ops)  # bound by its operations
    mm = roof.least_seconds(work["montmul"], 1 << 16, peaks)
    assert mm == pytest.approx(3 * 144 * (1 << 16) / 3.35e12)  # bytes
    rows = [("void coop_kernel<bn254::CoopMillerDblBody, 8>(long const*, "
             "long*, long)", 0, int(4 * least * 1e9)),
            ("void at::native::elementwise_kernel<...>", 0, 10**9),
            ("void coop_kernel<bn254::CoopNewBody, 8>(long const*, long*, "
             "long)", 0, int(4 * least * 1e9))]
    prof = call(9, 0, 1, launches=[("miller_dbl_body", lanes),
                                   ("unknown_key", 5)])
    run = make_run([], profiled=[prof], trace=TR.DeviceTrace(rows, 0, 10**9))
    # the aten row is not the port's; the unnamed coop row counts below
    assert roof.read(run) == pytest.approx(100 * least / (8 * least),
                                           rel=1e-4)
    log = run.log.getvalue()
    assert "CoopNewBody" in log and "unknown_key" in log


def test_readers_stay_silent_without_their_source():
    run = make_run([call(0, 0, 1)])
    for name in ("kernels_roofline", "device_idle_share", "hash_ms",
                 "fused_launches", "peak_mem_mib"):
        assert spec.reader(name).read(run) is None


def test_counters_take_the_median_call():
    run = make_run([call(i, i, i + 1, counters={"fused_launches": n})
                    for i, n in enumerate([535, 535, 540])])
    assert spec.reader("fused_launches").read(run) == 535
