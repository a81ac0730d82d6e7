"""Faults planted in the program under test, and the control.

Each entry breaks the timed path at one place, for the length of a
`planted(name)` block, so that a run of the harness can be seen to come out
not correct. `hard_part_skipped` is the control: the verifier's final
exponentiation with its hard part left out, the shortcut that would tempt a
later change (a guarantee of the configuration broken: a verdict that is
no longer the pairing check's). Run one on the card with

    python3 -m bench_gpu.control --fault <name> --workload <cell> \
        --seed <n> --seconds <s> --trace 0
"""

from __future__ import annotations

import contextlib


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
}
CONTROL = "hard_part_skipped"


@contextlib.contextmanager
def planted(name: str):
    mod, attr, make = FAULTS[name]()
    orig = getattr(mod, attr)
    setattr(mod, attr, make(orig))
    try:
        yield
    finally:
        setattr(mod, attr, orig)
