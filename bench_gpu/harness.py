"""One run of one cell: set-up, the measured window, the traced calls, the
check against the reference, and the result.

Set-up loads the port's kernel libraries (built in the checkout on the first
run), loads the cell's inputs (inputs.py), hands them to the configuration's
entry (entries/) and warms up with the rotation's first calls. A seed whose
inputs are not in the cache yet has them made and stored first; `setup_s`
leaves that out, so that every run's set-up does the same work. The window
then runs whole calls back to back until `seconds` have passed; each call's
verdict is on the host when it returns. With `trace`, the per-layer
readers' spans, counters and launch records are installed for the window,
and `PROFILED_CALLS` more calls run under torch.profiler (device activity
only) for the device's busy time, its idle gaps and the kernels' time; the
spans then read the host clock alone, without synchronising the card.

Every call's verdict is then held against the reference's, and for
`SUM_SAMPLE` of the window's calls, drawn from the seed, the signature sum
of each fused pass against the reference's sum of the same signatures
under the weights the call drew.

A cell that asks for n > 1 cards runs as n ranks, one process a card
(ranks.py): this process is rank 0. It makes or loads the inputs, starts
ranks 1..n-1, and builds the entry with its `RankInfo`; every rank makes
the warm-up, window and profiled calls in step, rank 0 telling them each
call before its clock starts. Rank 0 alone times, traces and profiles.
After the window each rank hands rank 0 its verdicts, its `SumProbe`
captures and its card's peak, and the check holds every rank's: its S row
of a chunk is the sum over the lanes `mesh.shard_tree` gives it there.
A cell on one card starts no process and runs as it always has.
"""

from __future__ import annotations

import random
import statistics
import sys
import time
import traceback

import numpy as np

from . import faults
from . import inputs as INP
from . import ranks as RK
from . import spec
from . import tracing as TR
from .reference import bls

WARM_CALLS = 2
SUM_SAMPLE = 2
PROFILED_CALLS = 2
BREAKDOWN_ROWS = 10
NAME_CHARS = 120


class Run:
    """What the metric readers read."""

    def __init__(self, tuples: int):
        self.tuples = tuples  # per call
        self.setup_s = None
        self.first_call_s = None
        self.calls: list[TR.Call] = []  # the window's
        self.profiled: list[TR.Call] = []
        self.trace: TR.DeviceTrace | None = None
        self.peak_window_bytes = None
        self.log = sys.stderr

    def per_call(self, fn):
        """The median over the window's calls of fn(call), leaving out the
        calls for which it is None; None if every call is."""
        vals = [v for v in map(fn, self.calls) if v is not None]
        return statistics.median(vals) if vals else None


def _check_defaults(cfg: dict, keys) -> None:
    """The configuration states the port's config.DEFAULT for the `keys`
    that its entry leaves to it: refuse to run another one."""
    from bn254_tpu_torch import config as C

    for key in keys:
        if key in cfg and getattr(C.DEFAULT, key) != cfg[key]:
            raise RuntimeError(f"config.DEFAULT.{key} is "
                               f"{getattr(C.DEFAULT, key)!r}, the "
                               f"configuration states {cfg[key]!r}")


def _readers(workload: str, trace: bool) -> dict:
    kind = "per_layer" if trace else "end_to_end"
    return {m["name"]: (m, spec.reader(m["name"]))
            for m in spec.metrics_for(workload, kind)}


def _install(tracer: TR.Tracer, readers: dict) -> dict:
    """Install every reader's spans and hooks; return its counters."""
    spans, counters = {}, {}
    for _, mod in readers.values():
        for name, targets in getattr(mod, "SPANS", {}).items():
            for t in targets:
                spans.setdefault((name, t), None)
        counters.update(getattr(mod, "COUNTERS", {}))
    for name, target in spans:
        tracer.span(name, target)
    for _, mod in readers.values():
        if hasattr(mod, "install"):
            mod.install(tracer)
    return counters


class FallbackProbe:
    """Counts the calls into the tier a rejected batch falls back to (the
    configuration's `fallback`, "module:attr"): the fused check's verdict,
    which the entry's per-tuple answer does not show."""

    def __init__(self, target: str | None):
        self.n = 0
        self._tracer = TR.Tracer(lambda: None)
        if target is None:
            return

        def make(orig):
            def counted(*args, **kwargs):
                self.n += 1
                return orig(*args, **kwargs)
            return counted

        if not self._tracer.patch(target, make):
            raise RuntimeError(f"the port has no {target}")

    def restore(self) -> None:
        self._tracer.restore()


class SumProbe:
    """Keeps, for `k` of the window's calls drawn from the seed (a
    reservoir sample), the RLC weights the timed path drew
    (`random_weights`) and the signature-sum row S = sum_i [w_i]sig_i of
    each fused pass (the last row of `_fused_points`' affine points, one a
    chunk), as the program made them, for the reference to judge."""

    WEIGHTS = "bn254_tpu_torch.dist.batch_verify:random_weights"
    POINTS = "bn254_tpu_torch.dist.batch_verify:_fused_points"

    def __init__(self, seed: int, k: int):
        self.rng = random.Random(seed)
        self.k = k
        self.seen = 0
        self.slots: dict[int, tuple] = {}  # slot -> (call index, capture)
        self._slot = None
        self._cur = None
        self._tracer = TR.Tracer(lambda: None)

        def weights(orig):
            def drawn(*args, **kwargs):
                w = orig(*args, **kwargs)
                if self._cur is not None:
                    self._cur["weights"].append(w)
                return w
            return drawn

        def points(orig):
            def fused_points(*args, **kwargs):
                out = orig(*args, **kwargs)
                if self._cur is not None:
                    px, py, _, _, inf = out
                    self._cur["sums"].append((px.arr[:, -1], py.arr[:, -1],
                                              inf[-1]))
                return out
            return fused_points

        for target, make in ((self.WEIGHTS, weights), (self.POINTS, points)):
            if not self._tracer.patch(target, make):
                raise RuntimeError(f"the port has no {target}")

    def begin(self) -> None:
        i = self.seen
        self.seen += 1
        slot = i if i < self.k else self.rng.randrange(i + 1)
        self._slot = slot if slot < self.k else None
        self._cur = ({"weights": [], "sums": []}
                     if self._slot is not None else None)

    def end(self, index: int) -> None:
        if self._cur is not None:
            self.slots[self._slot] = (index, self._cur)
        self._slot = self._cur = None

    def restore(self) -> None:
        self._tracer.restore()

    def host(self) -> list:
        """[(call index, [(a, b) ints per weight draw], [S affine or None
        per fused pass])], in call order; frees the device tensors."""
        from bn254_tpu_torch.constants import MONT_R
        from bn254_tpu_torch.curve import glv as GLV
        from bn254_tpu_torch.fields import limbs as L

        r_inv = pow(MONT_R, -1, bls.P)
        out = []
        for index, cap in sorted(self.slots.values(), key=lambda c: c[0]):
            draws = [(L.to_ints(w.a).tolist(), L.to_ints(w.b).tolist())
                     if isinstance(w, GLV.GlvWeights) else None
                     for w in cap["weights"]]
            sums = [None if bool(inf) else
                    (int(L.to_ints(x).reshape(-1)[0]) * r_inv % bls.P,
                     int(L.to_ints(y).reshape(-1)[0]) * r_inv % bls.P)
                    for x, y, inf in cap["sums"]]
            out.append((index, draws, sums))
        self.slots.clear()
        return out


def _sum_checks(captured, data, tuples: int, chunk: int,
                half_bits: int, rank: int = 0, world: int = 1) -> dict:
    """The sampled calls' weights and signature sums against the
    reference: `sum_mismatches`, the fused passes whose S differs from
    sum_i [a_i + lambda b_i] sig_i over the tuples of the chunk that
    `rank` of `world` sums (its shard of the chunk, `mesh.shard_tree`),
    or that are missing or extra; `weights_out_of_range`, the weights
    drawn that are not `tuples` GLV pairs (a, b) != (0, 0) of `half_bits`
    bits each."""
    mismatches = bad_weights = 0
    n_chunks = tuples // chunk
    shard = chunk // world
    for index, draws, sums in captured:
        entry = data.entries[index % len(data.entries)]
        if len(draws) != 1 or draws[0] is None or len(draws[0][0]) != tuples:
            bad_weights += tuples
            mismatches += n_chunks
            continue
        a, b = draws[0]
        bad_weights += sum((ai >> half_bits) > 0 or (bi >> half_bits) > 0
                           or ai == bi == 0 for ai, bi in zip(a, b))
        sigs = data.sigs_of(entry)
        mismatches += abs(len(sums) - n_chunks)
        for j, got in enumerate(sums[:n_chunks]):
            lo = j * chunk + rank * shard
            lanes = slice(lo, lo + shard)
            want = bls.g1_glv_sum(a[lanes], b[lanes], sigs[lanes])
            mismatches += got != want
    return {"sum_mismatches": {"value": mismatches, "limit": 0},
            "weights_out_of_range": {"value": bad_weights, "limit": 0}}


def _timed_call(caller, i, tracer, counters, probe=None, sums=None,
                ranks=None) -> TR.Call:
    if ranks is not None:
        ranks.call(i, sums is not None)
    before = {k: TR.counter_value(t) for k, t in counters.items()}
    fell = probe.n if probe else 0
    if sums is not None:
        sums.begin()
    call = TR.Call(i, time.perf_counter(), 0.0, time.time_ns(), 0)
    if tracer is not None:
        tracer.call = call
    call.verdict = caller.call(i)
    call.t1, call.t1_ns = time.perf_counter(), time.time_ns()
    if tracer is not None:
        tracer.call = None
    if sums is not None:
        sums.end(i)
    for k, t in counters.items():
        after = TR.counter_value(t)
        if after is not None and before[k] is not None:
            call.counters[k] = after - before[k]
    call.fell_back = bool(probe and probe.n > fell)
    return call


def _verdicts_wrong(got, want) -> int:
    """Verdicts that differ from the reference's: per tuple for an array of
    them, one for a call's single verdict."""
    want = np.asarray(want)
    got = np.asarray(got)
    if got.shape != want.shape:
        return int(want.size)
    return int((got != want).sum())


def run_cell(workload: str | dict, seed: int, seconds: float, trace: bool,
             device: str = "cuda", overrides: dict | None = None,
             traffic_overrides: dict | None = None, cache=INP.CACHE,
             warm_calls: int = WARM_CALLS, t_start: float | None = None,
             log=sys.stderr, rank_faults: dict | None = None) -> dict:
    """Run the cell once; returns the result (its keys as the last line
    prints them, and in a cell of several ranks `foreign`, each rank's
    modules of JAX or the JAX package as "rank <r>: <name>"). `workload`:
    the name of a cell of BENCHMARK.json, or a cell's keys (name, config,
    traffic, chips), as the tests run one that it does not list. `overrides`
    (`chips` too: the number of ranks), `traffic_overrides` and
    `warm_calls` shrink a run for the CPU tests; `rank_faults`, {rank:
    [fault names]}, plants faults in ranks other than 0 besides the faults
    planted here."""
    t_start = time.perf_counter() if t_start is None else t_start
    import torch

    wl = spec.workload(workload) if isinstance(workload, str) else workload
    workload = wl["name"]
    cfg = {**spec.config(wl["config"]), **(overrides or {})}
    traffic = {**spec.traffic(wl["traffic"]), **(traffic_overrides or {})}
    entry = spec.entry(cfg["entry"])
    _check_defaults(cfg, entry.READS_DEFAULT)
    world = cfg["chips"]
    on_card = torch.device(device).type == "cuda"
    sync = torch.cuda.synchronize if on_card else (lambda: None)
    if on_card:
        from bn254_tpu_torch.kernels import build

        for lib in ("fused", "montmul"):
            build.library(lib)

    t_make = time.perf_counter()
    made = INP.ensure(workload, cfg, traffic, seed, cache)
    made_s = time.perf_counter() - t_make if made else 0.0
    data = INP.load(workload, cfg, traffic, seed, cache)
    print(f"inputs: {f'made in {made_s:.3f} s, not in setup_s, and' if made else ''}"
          f" loaded ({workload}, seed {seed})", file=log)
    group = None
    if world > 1:
        group = RK.Ranks.start(
            world, {"workload": wl, "seed": seed, "device": device,
                    "overrides": overrides or {},
                    "traffic_overrides": traffic_overrides or {},
                    "cache": str(cache), "backend": cfg.get("backend")},
            {r: faults.ACTIVE + (rank_faults or {}).get(r, [])
             for r in range(1, world)}, log)
    try:
        caller = (entry.Caller(cfg, data, device) if group is None else
                  entry.Caller(cfg, data, RK.device_for(device, 0),
                               rank=group.info(cfg.get("backend"))))
        tuples = caller.tuples
        run = Run(tuples)
        run.log = log

        probe = FallbackProbe(cfg.get("fallback"))
        checked: list[TR.Call] = []
        for i in range(warm_calls):
            c = _timed_call(caller, i, None, {}, probe=probe, ranks=group)
            checked.append(c)
            if i == 0:
                run.first_call_s = c.seconds
        sync()
    except BaseException:
        if group is not None:
            group.stop()
        raise
    run.setup_s = time.perf_counter() - t_start - made_s
    setup_peak = torch.cuda.max_memory_allocated() if on_card else 0

    sums = SumProbe(seed, SUM_SAMPLE)
    readers = _readers(workload, trace)
    tracer = TR.Tracer(sync) if trace else None
    counters = _install(tracer, readers) if trace else {}
    failed_tuples = 0
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    try:
        i = warm_calls
        t0 = time.perf_counter()
        while True:
            run.calls.append(_timed_call(caller, i, tracer, counters,
                                         probe=probe, sums=sums,
                                         ranks=group))
            i += 1
            if run.calls[-1].t1 - t0 >= seconds:
                break
        run.peak_window_bytes = (torch.cuda.max_memory_allocated()
                                 if on_card else None)
        if trace:
            run.profiled, run.trace = _profile(caller, i, tracer, counters,
                                               on_card, probe, group)
    except Exception:  # a call that raises fails the run; report it
        traceback.print_exc(file=log)
        failed_tuples = tuples
    finally:
        if tracer is not None:
            tracer.restore()
        sums.restore()
        probe.restore()
        if group is not None and not failed_tuples:
            group.finish()
    checked += run.calls + run.profiled
    print(f"setup: {run.setup_s:.3f} s, warm-up calls "
          + " ".join(f"{c.seconds:.3f}" for c in checked[:warm_calls])
          + f" s; window: {len(run.calls)} calls of "
          + " ".join(f"{c.seconds:.3f}" for c in run.calls) + " s", file=log)
    peak = max(setup_peak, torch.cuda.max_memory_allocated()
               if on_card else 0)

    captured = sums.host()
    expected = {c.index: caller.expected(c.index) for c in checked}.get
    if group is not None:
        # every rank leaves the process group together, then exits; after
        # a failed call the ranks are ended first
        if failed_tuples:
            group.stop()
        caller.close()
        group.stop(RK.RESULT_S)
    del caller  # the program's state, before the reference's work
    wrong = sum(_verdicts_wrong(c.verdict, expected(c.index))
                for c in checked)
    checks = {"wrong_verdicts": {"value": wrong, "limit": 0}}
    if cfg.get("fallback"):
        # a batch falls back exactly when it holds an invalid tuple
        checks["fallback_mismatches"] = {"value": sum(
            c.fell_back != (not bool(np.all(expected(c.index))))
            for c in checked), "limit": 0}
    t_ref = time.perf_counter()
    half_bits = cfg["rlc_bits"] // 2
    chunk = cfg.get("chunk", tuples)
    checks.update(_sum_checks(captured, data, tuples, chunk, half_bits,
                              0, world))
    failed_ranks, foreign = [], []
    if group is not None:
        failed_ranks, foreign = _rank_checks(checks, group, checked, expected,
                                    [c[0] for c in captured], data, tuples,
                                    chunk, half_bits)
        peak = max([peak] + [res["peak"] for res in group.results.values()])
    print(f"reference: {len(captured)} sampled calls' signature sums "
          f"{f'on each of {world} ranks ' if group else ''}in "
          f"{time.perf_counter() - t_ref:.3f} s", file=log)
    checks["failed_calls"] = {"value": int(failed_tuples > 0
                                           or bool(failed_ranks)),
                              "limit": 0}
    correct = bool(run.calls) and all(
        v["value"] <= v["limit"] for v in checks.values())

    metrics = {}
    for name, (m, mod) in readers.items():
        value = mod.read(run)
        if value is not None:
            metrics[name] = {"value": value, "unit": m["unit"]}
    dev = {"platform": "gpu" if on_card else "cpu",
           "kind": torch.cuda.get_device_name(0) if on_card else "cpu",
           "count": world, "memory_peak_bytes": int(peak)}
    result = {"correct": correct,
              "attempted": tuples * len(checked),
              "failed": failed_tuples, "metrics": metrics, "device": dev}
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s()
        dev["window_s"] = run.trace.window_s
        result["breakdown"] = _breakdown(run)
    if tracer is not None and tracer.missing:
        print("trace: not found in the port: " + ", ".join(tracer.missing),
              file=log)
    if group is not None:
        result["foreign"] = foreign
    result["checks"] = checks
    return result


def _rank_checks(checks, group, checked, expected, sampled, data, tuples,
                 chunk, half_bits) -> list[int]:
    """Add ranks 1..n-1's results to `checks`: each rank's verdict for
    every call that rank 0 made, missing ones counting wrong; its S rows
    and weight draws (`_sum_checks` over its shards), the calls that rank
    0 sampled and it did not, or the other way round, counting every
    chunk's row as a mismatch. Returns the ranks that failed (died, raised,
    sent no result, or loaded JAX or the JAX package) and the modules
    found, as "rank <r>: <name>"."""
    failed, foreign = [], []
    n_chunks = tuples // chunk
    for r in range(1, group.world):
        res = group.results.get(r)
        found = [f"rank {r}: {m}" for m in (res or {}).get("foreign", [])]
        foreign += found
        if res is None or res["error"] is not None or found:
            failed.append(r)
            print(f"ranks: rank {r} failed: "
                  + ("no result" if res is None else
                     res["error"] or "loaded " + ", ".join(found)),
                  file=group.log)
        got = dict(res["verdicts"]) if res else {}
        checks["wrong_verdicts"]["value"] += sum(
            _verdicts_wrong(got[c.index], expected(c.index)) if c.index in got
            else int(np.asarray(expected(c.index)).size) for c in checked)
        captured = res["captured"] if res else []
        mine = [c for c in captured if c[0] in sampled]
        for k, v in _sum_checks(mine, data, tuples, chunk, half_bits,
                                r, group.world).items():
            checks[k]["value"] += v["value"]
        checks["sum_mismatches"]["value"] += n_chunks * (
            len(set(sampled) ^ {c[0] for c in captured}))
    return failed, foreign


def _profile(caller, i, tracer, counters, on_card, probe, ranks=None):
    """PROFILED_CALLS calls under torch.profiler; (calls, DeviceTrace).
    The spans stay to name the idle gaps, but read the host clock alone:
    a synchronisation at each edge would add idle time that the untraced
    path does not have."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    tracer.sync = lambda: None
    acts = [ProfilerActivity.CUDA] if on_card else [ProfilerActivity.CPU]
    calls = []
    with profile(activities=acts) as prof:
        for j in range(PROFILED_CALLS):
            calls.append(_timed_call(caller, i + j, tracer, counters,
                                     probe, ranks=ranks))
        if on_card:
            torch.cuda.synchronize()
    trace = TR.from_profiler(prof, calls[0].t0_ns, calls[-1].t1_ns)
    if trace.ops:
        first = min(o[1] for o in trace.ops) - trace.t0_ns
        print(f"trace: {len(trace.ops)} device operations in "
              f"{trace.window_s:.3f} s, the first {first * 1e-6:.3f} ms "
              "after the window's start", file=sys.stderr)
    return calls, trace


def _breakdown(run: Run) -> dict:
    ops = sorted(run.trace.op_seconds().items(), key=lambda kv: -kv[1])
    idle = sorted(TR.idle_by_span(run.trace, run.profiled).items(),
                  key=lambda kv: -kv[1])
    return {"device_ops": [[n[:NAME_CHARS], s] for n, s in
                           ops[:BREAKDOWN_ROWS]],
            "idle_gaps": [[n, s] for n, s in idle[:BREAKDOWN_ROWS]]}
