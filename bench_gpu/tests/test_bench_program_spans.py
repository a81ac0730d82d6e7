"""The readers of the port's own spans and counters (program_spans.py and
the seven metrics that read them) on synthetic calls, the recorder's
install and restore, a tiny traced CPU run, and, on the card, that a
kernel's device interval lies inside the program span that launched it."""

import pytest

from bench_gpu import harness
from bench_gpu import program_spans as PS
from bench_gpu import spec
from bench_gpu import tracing as TR
from test_bench_arithmetic import call, make_run
from test_bench_cpu_runs import cache, tiny_run  # noqa: F401

NEW = ("ladder_ms", "tree_sum_ms", "to_affine_ms", "final_exp_glue_ms",
       "fused_glue_ms", "hash_host_misses", "bounds_learn_s")
POINTS = ("points", "verify", "fused", "points")  # harness's, then program's


def points_call(i, scale=1.0):
    """A call whose points stage, 1 s long (scaled), holds its three
    program sub-spans."""
    s = scale
    return call(i, 0.0, 10.0, spans=[
        ("points.ladder", POINTS, 1.0, 1.0 + 0.1 * s),
        ("points.tree_sum", POINTS, 1.0 + 0.1 * s, 1.0 + 0.8 * s),
        ("points.to_affine", POINTS, 1.0 + 0.8 * s, 1.0 + 0.95 * s),
        ("points", ("points", "verify", "fused"), 1.0, 1.0 + s),
        ("points", (), 1.0, 1.0 + s)])


def test_points_sub_spans_sum_to_the_points_stage():
    run = make_run([points_call(0), points_call(1, 2.0), points_call(2)])
    got = {n: spec.reader(n).read(run)
           for n in ("ladder_ms", "tree_sum_ms", "to_affine_ms")}
    assert got == pytest.approx({"ladder_ms": 100.0, "tree_sum_ms": 700.0,
                                 "to_affine_ms": 150.0})
    assert spec.reader("points_ms").read(run) == pytest.approx(1000.0)
    assert sum(got.values()) == pytest.approx(950.0)


def test_final_exp_glue_leaves_out_exp_u_and_the_independent_tier():
    fe, ind = ("final_exp", "verify", "fused", "final_exp"), (
        "fallback", "final_exp", "verify", "independent", "final_exp")
    c = call(0, 0.0, 10.0, spans=[
        ("final_exp.easy", fe, 1.0, 1.1),
        ("final_exp.exp_u", fe, 1.1, 1.2),
        ("final_exp.hard", fe, 1.2, 1.35),
        ("is_one", ("verify", "fused"), 1.4, 1.5),
        ("final_exp.easy", ind, 3.0, 3.5),
        ("final_exp.hard", ind, 3.6, 4.0)])
    run = make_run([c, c, c])
    assert spec.reader("final_exp_glue_ms").read(run) == pytest.approx(350.0)


def test_counters_read_per_call_and_a_zero_is_reported():
    calls = [call(i, i, i + 1, counters={"fused_glue_ms": ns,
                                         "hash_host_misses": m})
             for i, (ns, m) in enumerate([(2e8, 30), (1e8, 34), (3e8, 0)])]
    run = make_run(calls)
    assert spec.reader("fused_glue_ms").read(run) == pytest.approx(200.0)
    assert spec.reader("hash_host_misses").read(run) == 30
    zero = make_run([call(0, 0, 1, counters={"hash_host_misses": 0})])
    assert spec.reader("hash_host_misses").read(zero) == 0


def test_bounds_learn_s_reads_the_process_total(monkeypatch):
    from bn254_tpu_torch.kernels import fused as FK

    monkeypatch.setattr(FK, "bounds_learn_ns", 3_250_000_000)
    monkeypatch.setattr(FK, "bounds_learned", 41)
    run = make_run([])
    assert spec.reader("bounds_learn_s").read(run) == pytest.approx(3.25)
    assert "41 bodies learned" in run.log.getvalue()


def test_silent_when_the_source_is_missing(monkeypatch):
    from bn254_tpu_torch.kernels import fused as FK

    run = make_run([call(0, 0.0, 1.0, spans=[("points", (), 0.1, 0.9)])])
    for name in NEW:
        if name != "bounds_learn_s":
            assert spec.reader(name).read(run) is None, name
    monkeypatch.delattr(FK, "bounds_learn_ns")
    assert spec.reader("bounds_learn_s").read(run) is None


def test_install_forwards_program_spans_under_the_harness_stack():
    from bn254_tpu_torch import obs

    syncs = []
    tracer = TR.Tracer(lambda: syncs.append(1))
    for name in ("ladder_ms", "fused_glue_ms", "tree_sum_ms"):
        spec.reader(name).install(tracer)  # idempotent: one recorder
    assert len(tracer._saved) == 1 and isinstance(obs.recorder, obs.Recorder)
    tracer.call = c = TR.Call(0, 0.0, 0.0, 0, 0)
    tracer._stack.append("points")
    with obs.span("fused"):
        with obs.span("points.tree_sum"):
            pass
    tracer._stack.pop()
    tracer.call = None
    with obs.span("outside a call"):
        pass
    tracer.restore()
    assert obs.recorder is None
    assert [(s.name, s.path) for s in c.spans] == [
        ("points.tree_sum", ("points", "fused")), ("fused", ("points",))]
    assert len(syncs) == 6  # both edges of each span, the tracer's sync
    assert c.spans[0].t0_ns <= c.spans[0].t1_ns


def test_install_on_a_port_without_obs_does_nothing(monkeypatch):
    monkeypatch.setattr(PS, "TARGET", "bn254_tpu_torch.no_such:recorder")
    tracer = TR.Tracer(lambda: None)
    PS.install(tracer)
    PS.install(tracer)
    assert tracer.missing == [PS.TARGET] and not tracer._saved


def test_traced_cpu_run_reports_the_new_metrics(cache, monkeypatch):
    """cfg4-b8192-valid at 2 tuples, traced: every new metric reports, the
    points stage's parts stay within it, and the idle breakdown names the
    program's spans."""
    monkeypatch.setattr(harness, "PROFILED_CALLS", 1)
    r = tiny_run("cfg4-b8192-valid", cache, trace=True)
    assert r["correct"], r["checks"]
    m = {k: v["value"] for k, v in r["metrics"].items()}
    assert set(NEW) <= set(m)
    parts = m["ladder_ms"] + m["tree_sum_ms"] + m["to_affine_ms"]
    assert 0 < parts <= m["points_ms"]
    assert m["fused_glue_ms"] == 0  # the CPU takes no kernel
    assert m["hash_host_misses"] >= 0 and m["bounds_learn_s"] >= 0
    assert m["final_exp_glue_ms"] > 0
    assert any("/" in n for n, _ in r["breakdown"]["idle_gaps"])


@pytest.mark.card
def test_kernel_lies_inside_its_synchronised_span(card):
    """A fused launch inside a program span that synchronises at its edges,
    under torch.profiler: the kernel's device interval starts after the
    span's t0_ns and ends before its t1_ns, so the profiler's device clock
    and the spans' are one."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bn254_tpu_torch import obs
    from bn254_tpu_torch.fields import limbs as L
    from bn254_tpu_torch.kernels import fused as FK
    from bn254_tpu_torch.utils import convert as CV
    from bn254_tpu_torch.utils import samples as SM

    rng = np.random.default_rng(3)
    pins = (L.STD_BOUND, 1 << 16)
    args = FK.args_from_leaves("fq12_mul", [
        CV.from_numpy(SM.bounded_limbs(rng, *pins, 4096), *pins, "cuda")
        for _ in range(24)])
    body, _ = FK.signature("fq12_mul")
    FK.fused_op(body, "fq12_mul", *args)  # build, learn the bounds
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        with obs.recording(sync=torch.cuda.synchronize) as rec:
            with obs.span("launch"):
                FK.fused_op(body, "fq12_mul", *args)
    (span,) = rec.spans
    trace = TR.from_profiler(prof, span.t0_ns, span.t1_ns)
    kernels = [o for o in trace.ops if "bn254" in o[0] or "coop" in o[0]]
    assert kernels, [o[0] for o in trace.ops]
    for _, a, b in kernels:
        assert span.t0_ns < a <= b < span.t1_ns
