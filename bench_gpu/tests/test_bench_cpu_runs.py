"""Whole runs of each cell on the CPU at a tiny size: the harness's check
passes on the port as it is, and fails with the control or a fault planted
underneath (faults.py). These skip the harness's look for a card and drive
the rest of a run, the port's plain torch path in the kernels' place; each
takes tens of seconds."""

import pytest

from bench_gpu import faults, harness

TINY = {"cfg4-b8192-valid": {"tuples": 2},
        "cfg4-b8192-onebad": {"tuples": 2},
        "cfg5-chunked-32k": {"tuples": 4, "chunk": 2}}
# a call of cfg5's rotation that holds the bad tuple, for the faults that
# only a bad tuple shows: anywhere, or in the last chunk
BAD_CALL = {"distinct_batches": 1, "rotation": [{"batch": 0, "invalid": 1}]}
LAST_CHUNK_BAD = {"distinct_batches": 1, "rotation": [
    {"batch": 0, "invalid": 1, "within": [0.5, 1]}]}
SEED = 2**31 + 17


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("inputs")


def failed_checks(r):
    return sorted(k for k, c in r["checks"].items() if c["value"] > c["limit"])


def tiny_run(cell, cache, trace=False, traffic=None):
    return harness.run_cell(cell, SEED, 0, trace, device="cpu",
                            overrides=TINY[cell], traffic_overrides=traffic,
                            cache=cache, warm_calls=0)


@pytest.mark.parametrize("cell", sorted(TINY))
def test_sound_run_is_correct(cell, cache):
    r = tiny_run(cell, cache)
    assert r["correct"] and not failed_checks(r), r["checks"]
    assert {"sum_mismatches", "weights_out_of_range"} <= set(r["checks"])
    assert r["attempted"] == TINY[cell]["tuples"]
    assert set(r["metrics"]) == {"verifies_per_s", "setup_s"}


@pytest.mark.parametrize("cell", sorted(TINY))
def test_control_is_not_correct(cell, cache):
    with faults.planted(faults.CONTROL):
        r = tiny_run(cell, cache)
    assert not r["correct"] and "wrong_verdicts" in failed_checks(r)


# A fault of the fused tier alone leaves cfg4's verdicts right (the
# independent tier answers a rejected batch) and shows as a fallback where
# none is due; in cfg4-b8192-onebad, where every call falls back, half of
# the batch is left out of the independent tier instead.
CASES = [(c, f) for c in sorted(TINY) for f in ("exp_u_unchanged",
                                                 "hash_altered")]
CASES += [("cfg4-b8192-valid", "half_tree_sum"),
          ("cfg5-chunked-32k", "half_tree_sum"),
          ("cfg4-b8192-onebad", "half_independent"),
          ("cfg4-b8192-onebad", "always_accept"),
          ("cfg5-chunked-32k", "always_accept"),
          ("cfg4-b8192-valid", "half_batch"),
          ("cfg5-chunked-32k", "half_batch"),
          ("cfg5-chunked-32k", "chunk_dropped"),
          ("cfg5-chunked-32k", "combine_unchanged")]
TRAFFIC = {("cfg5-chunked-32k", "always_accept"): BAD_CALL,
           ("cfg5-chunked-32k", "combine_unchanged"): LAST_CHUNK_BAD}
# faults that leave every verdict right on all-valid traffic, and the check
# that catches them there
SEEN_BY = {("cfg4-b8192-valid", "half_batch"): "sum_mismatches",
           ("cfg5-chunked-32k", "half_batch"): "sum_mismatches",
           ("cfg5-chunked-32k", "chunk_dropped"): "sum_mismatches"}


@pytest.mark.parametrize("cell,fault", CASES)
def test_fault_is_caught(cell, fault, cache):
    with faults.planted(fault):
        r = tiny_run(cell, cache, traffic=TRAFFIC.get((cell, fault)))
    assert not r["correct"] and failed_checks(r)
    assert "failed_calls" not in failed_checks(r)
    if (cell, fault) in SEEN_BY:
        assert SEEN_BY[cell, fault] in failed_checks(r)


def test_traced_run_reads_its_spans(cache, monkeypatch):
    monkeypatch.setattr(harness, "PROFILED_CALLS", 1)
    r = tiny_run("cfg4-b8192-onebad", cache, trace=True)
    assert r["correct"], r["checks"]
    m = r["metrics"]
    for name in ("hash_ms", "points_ms", "miller_ms", "final_exp_ms",
                 "fallback_ms", "host_prep_ms", "first_call_s"):
        assert name in m or name == "first_call_s"
    assert m["fallback_ms"]["value"] > m["miller_ms"]["value"] > 0
    # the CPU has no device trace: its readers stay silent
    assert "kernels_roofline" not in m and "device_idle_share" not in m
    assert r["device"]["window_s"] > 0 and "breakdown" in r
