"""The port's tracing (`bn254_tpu_torch/obs.py`) and the counters beside it.

Spans nest with their parents and one call id under each top-level span;
with no recorder `span` is the shared null context and `fused_op` reads no
clock. One smallest-batch adaptive verification through `api.batch_verify`,
on the card's composition with the g++ build of `fused.cu` standing in for
the card (the `host_card` fixture of tests/test_torch_fused_host.py), one
signature tampered, records the span tree of README.md's "Tracing". The
hash's `host_fallbacks` counts the messages its device search missed, and
`fused._out_struct`'s misses are counted and timed.
"""

import numpy as np
import pytest

from bn254_tpu_torch import api, obs
from bn254_tpu_torch.dist import batch_verify as BV
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.hash import tai_batch as TB
from bn254_tpu_torch.hash.tai import hash_to_g1, hash_to_g1_with_ctr
from bn254_tpu_torch.host import curve as HC
from bn254_tpu_torch.kernels import fused as FK
from bn254_tpu_torch.protocol.types import PublicKey, Signature
from bn254_tpu_torch.utils import convert as CV
from bn254_tpu_torch.utils import samples as SM
from test_torch_fused_host import host_card, host_lib  # noqa: F401


def names(rec):
    return ["/".join(s.path + (s.name,)) for s in rec.spans]


def test_spans_nest_with_parents_and_call_ids():
    syncs = []
    with obs.recording(sync=lambda: syncs.append(1)) as rec:
        assert obs.recorder is rec
        with obs.span("a") as a:
            with obs.span("b") as b:
                pass
            with obs.span("c"):
                with obs.span("d") as d:
                    pass
        with obs.span("e") as e:
            pass
    assert obs.recorder is None
    assert names(rec) == ["a/b", "a/c/d", "a/c", "a", "e"]
    assert b.parent is a and d.parent.name == "c" and a.parent is None
    assert {s.call_id for s in rec.spans[:4]} == {a.call_id} != {e.call_id}
    assert all(s.t0_ns <= s.t1_ns for s in rec.spans)
    assert a.t0_ns <= b.t0_ns and d.t1_ns <= a.t1_ns <= e.t0_ns
    assert len(syncs) == 2 * len(rec.spans)  # both edges of each span


def test_callback_receives_each_span_and_recorders_restore():
    got = []
    with obs.recording() as outer:
        with obs.recording(on_span=got.append) as inner:
            with obs.span("x"):
                with obs.span("y"):
                    pass
        assert obs.recorder is outer
        with obs.span("z"):
            pass
    assert [s.name for s in got] == ["y", "x"] and not inner.spans
    assert [s.name for s in outer.spans] == ["z"]
    assert obs.recorder is None


def test_off_path_records_nothing_and_reads_no_clock(host_card, monkeypatch):
    """No recorder: `span` hands out the one shared null context, and
    `fused_op`'s CUDA path leaves `host_ns` where it was; with one
    installed it adds each launch's host time."""
    assert obs.recorder is None
    assert obs.span("points") is obs.span("final_exp") is obs._OFF
    with obs.span("points") as s:
        assert s is None
    monkeypatch.setattr(FK, "host_ns", 0)
    body, _ = FK.signature("fq12_mul")
    rng = np.random.default_rng(5)
    args = FK.args_from_leaves("fq12_mul", [
        CV.from_numpy(SM.bounded_limbs(rng, L.STD_BOUND, 1 << 16, 3),
                      L.STD_BOUND, 1 << 16) for _ in range(24)])
    FK.fused_op(body, "fq12_mul", *args)
    assert host_card(fq12_mul=1) and FK.host_ns == 0
    with obs.recording() as rec:
        FK.fused_op(body, "fq12_mul", *args)
    assert host_card(fq12_mul=1) and FK.host_ns > 0 and not rec.spans


def test_api_adaptive_records_the_span_tree(host_card, monkeypatch):
    """api.batch_verify(mode="adaptive") on B=2, signature 1 tampered: the
    fused tier rejects and the independent tier answers, under one call
    id; every span of the tree (but `resolve.wait`, which waits on a CUDA
    event) is recorded in order, and `host_ns` moves."""
    from bn254_tpu_torch import config as C

    monkeypatch.setattr(C, "DEFAULT", C.DEFAULT.replace(rlc_bits=16))
    monkeypatch.setattr(FK, "host_ns", 0)
    msgs = [b"obs-%d" % i for i in range(2)]
    sks = [31, 47]
    sigs = [HC.g1_mul(hash_to_g1(m), k) for m, k in zip(msgs, sks)]
    sigs[1] = HC.g1_mul(sigs[1], 2)
    with obs.recording() as rec:
        got = api.batch_verify(
            msgs, [Signature(s) for s in sigs],
            [PublicKey(HC.g2_mul(HC.G2_ONE, k)) for k in sks],
            mode="adaptive", device="cpu")
    assert got.tolist() == [True, False]
    fe = ["final_exp.easy", *["final_exp.exp_u"] * 3, "final_exp.hard"]
    fused = "verify/fused"
    assert names(rec) == [
        "verify/hash/hash.search", "verify/hash", "verify/convert",
        "verify/weights", *(f"{fused}/points/points.{n}"
                            for n in ("ladder", "tree_sum", "to_affine")),
        f"{fused}/points", f"{fused}/miller",
        *(f"{fused}/final_exp/{n}" for n in fe), f"{fused}/final_exp",
        f"{fused}/is_one", fused,
        *(f"verify/independent/final_exp/{n}" for n in fe),
        "verify/independent/final_exp", "verify/independent", "verify"]
    assert len({s.call_id for s in rec.spans}) == 1
    assert FK.host_ns > 0


def test_resolve_waits_on_the_event_in_a_span():
    class Event:
        waited = 0

        def synchronize(self):
            self.waited += 1

    ev = Event()
    res = BV.AdaptiveResult("per-tuple", True, ev, fallback=None)
    with obs.recording() as rec:
        assert res.resolve() == "per-tuple" and res.resolve() == "per-tuple"
    assert ev.waited == 1 and names(rec) == ["resolve.wait"]


def test_host_fallbacks_count_the_device_search_misses(monkeypatch):
    """At K=1 the messages whose first counter fails go to the host: the
    counter moves by exactly their number, in `hash.host_fallback`."""
    msgs = [b"miss-%02d" % i for i in range(6)]
    want = sum(hash_to_g1_with_ctr(m)[1] > 0 for m in msgs)
    assert 0 < want < len(msgs)
    monkeypatch.setattr(TB, "host_fallbacks", 0)
    with obs.recording() as rec:
        x, _ = TB.hash_to_g1_device(msgs, 1)
    assert TB.host_fallbacks == want
    assert names(rec) == ["hash/hash.search", "hash/hash.host_fallback",
                          "hash"]
    assert CV.g1_batch_to_device_affine(
        [hash_to_g1(m) for m in msgs])[0].arr.tolist() == x.arr.tolist()
    TB.hash_to_g1_device(msgs, 8)
    assert TB.host_fallbacks == want + sum(
        hash_to_g1_with_ctr(m)[1] >= 8 for m in msgs)


def test_bounds_learning_is_counted_and_timed(host_card, monkeypatch):
    """A forced miss of `_out_struct` (its cache emptied) counts one body
    learned and its ns; the second call hits the cache."""
    monkeypatch.setattr(FK, "_out_structs", {})
    monkeypatch.setattr(FK, "bounds_learned", 0)
    monkeypatch.setattr(FK, "bounds_learn_ns", 0)
    body, _ = FK.signature("fq12_cyc_sq")
    rng = np.random.default_rng(9)
    args = FK.args_from_leaves("fq12_cyc_sq", [
        CV.from_numpy(SM.bounded_limbs(rng, L.STD_BOUND, 1 << 16, 2),
                      L.STD_BOUND, 1 << 16) for _ in range(12)])
    FK.fused_op(body, "fq12_cyc_sq", *args)
    assert host_card(fq12_cyc_sq=1)
    # arity() may learn the key's template at the standard bounds first
    learned, ns = FK.bounds_learned, FK.bounds_learn_ns
    assert learned == len(FK._out_structs) >= 1 and ns > 0
    FK.fused_op(body, "fq12_cyc_sq", *args)
    assert (FK.bounds_learned, FK.bounds_learn_ns) == (learned, ns)
