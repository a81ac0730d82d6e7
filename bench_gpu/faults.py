"""Faults planted in the program under test, and the control.

Each entry breaks the timed path at one place, for the length of a
`planted(name)` block, so that a run of the harness can be seen to come out
not correct. `hard_part_skipped` is the control: the verifier's final
exponentiation with its hard part left out, the shortcut that would tempt a
later change (a guarantee of the configuration broken: a verdict that is
no longer the pairing check's). Run one on the card with

    python3 -m bench_gpu.control --fault <name> --workload <cell> \
        --seed <n> --seconds <s> --trace 0

In a cell of several ranks (ranks.py) a fault planted in rank 0 is planted
in every rank; the tests plant one in another rank alone.
"""

from __future__ import annotations

import contextlib
import os
import sys
import time
import types


def _hard_part_skipped():
    from bn254_tpu_torch.fields import tower as T
    from bn254_tpu_torch.pairing import final_exp as FE

    return FE, "final_exp", lambda orig: (
        lambda f: T.fq12_retag(FE.easy_part(T.fq12_retag(f))))


def _exp_u_unchanged():
    """A step that returns its state unchanged."""
    from bn254_tpu_torch.pairing import final_exp as FE

    return FE, "exp_u", lambda orig: (lambda f, window_digits=None: f)


def _half_tree_sum():
    """Half of the batch left out of the signature sum."""
    from bn254_tpu_torch.dist import batch_verify as BV
    from bn254_tpu_torch.fields import limbs as L

    def make(orig):
        def tree_sum(p, axis=0):
            def half(e):
                n = e.arr.shape[axis + 1]
                return L.El(e.arr.narrow(axis + 1, 0, max(1, n // 2)),
                            e.vmax, e.lmax)
            return orig(L.tree_map(half, p), axis)
        return tree_sum

    return BV, "_g1_tree_sum", make


def _half_batch():
    """Half of the batch left out of the fused tier, on both sides of its
    equation: each pass checks the first half of its tuples alone."""
    from bn254_tpu_torch.dist import batch_verify as BV

    def make(orig):
        def fused_points(*args):
            *els, nbits = args
            n = els[0].arr.shape[-1]
            half = slice(0, max(1, n // 2))
            return orig(*(BV._slice_batch(e, half) for e in els), nbits)
        return fused_points

    return BV, "_fused_points", make


def _chunk_dropped():
    """The chunked check stops after its first chunk."""
    from bn254_tpu_torch.dist import batch_verify as BV

    def make(orig):
        def chunked(*args, chunk, nbits=None):
            first = slice(0, chunk)
            return orig(*(BV._slice_batch(e, first) for e in args),
                        chunk=chunk, nbits=nbits)
        return chunked

    return BV, "verify_batch_fused_chunked", make


def _combine_unchanged():
    """A step that returns its state unchanged: a chunk's Miller product
    is not folded into the accumulator."""
    from bn254_tpu_torch.dist import batch_verify as BV

    return BV, "_chunk_combine", lambda orig: (lambda f_acc, f_c: f_acc)


def _half_independent():
    """Half of the batch left out of the independent tier: it checks the
    first half and repeats those verdicts for the rest."""
    from bn254_tpu_torch.dist import batch_verify as BV
    from bn254_tpu_torch.fields import limbs as L

    def make(orig):
        def independent(*els):
            n = els[0].arr.shape[-1]
            h = max(1, n // 2)
            ok = orig(*(L.tree_map(lambda e: L.El(e.arr[..., :h], e.vmax,
                                                  e.lmax), t) for t in els))
            return ok.repeat(-(-n // h))[:n]
        return independent

    return BV, "verify_batch_independent", make


def _hash_altered():
    """An answer altered where it is produced: the hash points of the
    first two messages swapped."""
    from bn254_tpu_torch.fields import limbs as L
    from bn254_tpu_torch.hash import tai_batch as TB

    def make(orig):
        def hash_batch(*args, **kwargs):
            x, y, found, ctr = orig(*args, **kwargs)

            def swap(e):
                a = e.arr.clone()
                a[:, [0, 1]] = e.arr[:, [1, 0]]
                return L.El(a, e.vmax, e.lmax)
            return swap(x), swap(y), found, ctr
        return hash_batch

    return TB, "hash_to_g1_batch", make


def _always_accept():
    """An answer altered where it is produced: every check says one."""
    from bn254_tpu_torch.fields import tower as T

    return T, "fq12_is_one", lambda orig: (lambda a: orig(a) | True)


def _allreduce_skipped():
    """The exchange between chips left out: each rank's Fq12 product goes
    to the final exponentiation alone."""
    from bn254_tpu_torch.dist import collectives as COLL

    return COLL, "fq12_allreduce_mul", lambda orig: (lambda f, mesh: f)


def _rank_dies():
    """A rank that dies at its next fused pass (plant it in a rank other
    than 0: in rank 0 it ends the run itself)."""
    from bn254_tpu_torch.dist import batch_verify as BV

    return BV, "_fused_points", lambda orig: (lambda *a, **k: os._exit(9))


def _rank_hangs():
    """A rank that goes silent at its next fused pass (plant it in a rank
    other than 0)."""
    from bn254_tpu_torch.dist import batch_verify as BV

    return BV, "_fused_points", lambda orig: (
        lambda *a, **k: time.sleep(3600))


def _loads_jax_package():
    """A fused pass that loads a module under the JAX package's name (an
    empty stand-in) into its process, and then runs as it does. Plant it
    in a rank other than 0, in a process of its own: the module stays."""
    from bn254_tpu_torch.dist import batch_verify as BV

    def make(orig):
        def fused_points(*args, **kwargs):
            sys.modules.setdefault("bn254_tpu", types.ModuleType("bn254_tpu"))
            return orig(*args, **kwargs)
        return fused_points
    return BV, "_fused_points", make


FAULTS = {
    "hard_part_skipped": _hard_part_skipped,
    "exp_u_unchanged": _exp_u_unchanged,
    "half_tree_sum": _half_tree_sum,
    "half_batch": _half_batch,
    "chunk_dropped": _chunk_dropped,
    "combine_unchanged": _combine_unchanged,
    "half_independent": _half_independent,
    "hash_altered": _hash_altered,
    "always_accept": _always_accept,
    "allreduce_skipped": _allreduce_skipped,
    "rank_dies": _rank_dies,
    "rank_hangs": _rank_hangs,
    "loads_jax_package": _loads_jax_package,
}
CONTROL = "hard_part_skipped"
ACTIVE: list[str] = []  # the names planted now, outermost first


@contextlib.contextmanager
def planted(name: str):
    mod, attr, make = FAULTS[name]()
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    ACTIVE.append(name)
    try:
        yield
    finally:
        ACTIVE.remove(name)
        setattr(mod, attr, orig)
