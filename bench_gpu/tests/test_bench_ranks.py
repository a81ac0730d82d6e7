"""Whole runs of the sharded cell (`sharded_cell`) on the CPU at a tiny
size, two ranks over gloo (ranks.py): every rank's verdicts, signature sums
and weight draws are held against the reference, a fault in one rank alone
is caught, a rank that loads the JAX package gets the run refused, and a
rank that dies or goes silent ends the run with `failed_calls` and leaves
no process behind. Each run starts one more process and takes a minute or
two."""

import json
import os
import time

import pytest

from bench_gpu import faults, harness, spec
from bench_gpu import ranks as RK
from bench_gpu import run as RUN

RANKS = 2
TINY = {"tuples": 8, "chunk": 4, "backend": "gloo", "chips": RANKS}
SEED = 2**31 + 29
# a call whose batch holds one bad tuple, anywhere, or in the last chunk
BAD_CALL = {"distinct_batches": 1, "rotation": [{"batch": 0, "invalid": 1}]}
LAST_CHUNK_BAD = {"distinct_batches": 1, "rotation": [
    {"batch": 0, "invalid": 1, "within": [0.5, 1]}]}
ENDS_WITHIN_S = 150


@pytest.fixture(scope="module")
def cache(tmp_path_factory):
    return tmp_path_factory.mktemp("inputs")


@pytest.fixture
def started(monkeypatch):
    """The `Ranks` that each run starts."""
    got = []
    start = RK.Ranks.start

    def recorded(*args, **kwargs):
        got.append(start(*args, **kwargs))
        return got[-1]

    monkeypatch.setattr(RK.Ranks, "start", recorded)
    return got


def failed_checks(r):
    return sorted(k for k, c in r["checks"].items() if c["value"] > c["limit"])


@pytest.fixture
def tiny_run(sharded_cell, cache):
    """One whole run of the cell at the tiny size."""
    def run(traffic=None, rank_faults=None):
        return harness.run_cell(sharded_cell, SEED, 0, False, device="cpu",
                                overrides=TINY, traffic_overrides=traffic,
                                cache=cache, warm_calls=0,
                                rank_faults=rank_faults)

    return run


def assert_no_rank_left(started):
    assert started
    for p in started[-1].procs:
        assert p.returncode is not None
        with pytest.raises(ProcessLookupError):
            os.kill(p.pid, 0)  # reaped, not a zombie


def test_sound_run_is_correct(tiny_run, started):
    r = tiny_run()
    assert r["correct"] and not failed_checks(r), r["checks"]
    assert r["device"]["count"] == RANKS and r["attempted"] == 8
    assert r["foreign"] == []
    assert {"sum_mismatches", "weights_out_of_range"} <= set(r["checks"])
    res = started[-1].results
    assert sorted(res) == [1] and res[1]["error"] is None
    assert res[1]["verdicts"] == [(0, True)]
    # rank 1 sampled the one window call: its two chunks' S rows, drawn
    # under its own full-batch weights
    (index, draws, sums), = res[1]["captured"]
    assert index == 0 and len(draws[0][0]) == 8 and len(sums) == 2
    assert_no_rank_left(started)


def test_control_is_not_correct(tiny_run, started):
    with faults.planted(faults.CONTROL):
        r = tiny_run()
    assert not r["correct"] and "wrong_verdicts" in failed_checks(r)
    assert "failed_calls" not in failed_checks(r)
    assert_no_rank_left(started)


def test_fault_in_one_rank_is_caught(tiny_run, started):
    """Half of rank 1's shard left out of its signature sum: rank 1's S
    rows are wrong, rank 0's right."""
    r = tiny_run(rank_faults={1: ["half_tree_sum"]})
    assert not r["correct"] and "sum_mismatches" in failed_checks(r)
    assert r["checks"]["sum_mismatches"]["value"] == 2  # rank 1's two rows
    assert_no_rank_left(started)


# the faults the sharded cell can have, planted in every rank: a step that
# returns its state unchanged, half of the batch left out, the exchange
# between the ranks left out, an answer altered where it is produced
CASES = {"exp_u_unchanged": None, "combine_unchanged": LAST_CHUNK_BAD,
         "half_batch": None, "allreduce_skipped": BAD_CALL,
         "hash_altered": None}


@pytest.mark.parametrize("fault", sorted(CASES))
def test_fault_is_caught(fault, tiny_run, started):
    with faults.planted(fault):
        r = tiny_run(traffic=CASES[fault])
    assert not r["correct"] and failed_checks(r)
    assert "failed_calls" not in failed_checks(r)
    if fault == "half_batch":
        assert "sum_mismatches" in failed_checks(r)
    assert_no_rank_left(started)


@pytest.mark.parametrize("fault", ["rank_dies", "rank_hangs"])
def test_lost_rank_ends_the_run(fault, tiny_run, started):
    """Rank 1 dies or goes silent at its first fused pass, the run's first
    call: the whole run ends within the limit."""
    t0 = time.monotonic()
    r = tiny_run(rank_faults={1: [fault]})
    assert time.monotonic() - t0 < ENDS_WITHIN_S
    assert not r["correct"] and r["checks"]["failed_calls"]["value"] == 1
    assert_no_rank_left(started)


def test_rank_that_loads_the_jax_package_is_refused(tiny_run, started,
                                                    sharded_cell,
                                                    monkeypatch, capsys):
    """Rank 1 loads a module named as the JAX package: the run fails its
    check, and the command refuses it, exit code 3 and no result line."""
    r = tiny_run(rank_faults={1: ["loads_jax_package"]})
    assert r["foreign"] == ["rank 1: bn254_tpu"]
    assert not r["correct"] and r["checks"]["failed_calls"]["value"] == 1
    assert_no_rank_left(started)

    import torch

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: RANKS * 2)
    monkeypatch.setattr(harness, "run_cell",
                        lambda *a, **k: json.loads(json.dumps(r)))
    monkeypatch.setattr(spec, "workload", lambda name: sharded_cell)
    capsys.readouterr()
    assert RUN.main(["--workload", sharded_cell["name"], "--seed", str(SEED),
                     "--seconds", "0"]) == 3
    out, err = capsys.readouterr()
    assert out == "" and "rank 1: bn254_tpu" in err
