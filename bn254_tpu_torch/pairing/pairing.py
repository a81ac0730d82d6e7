"""Pairing API: single, batched and product-reduced pairings.

Counterpart of `bn254_tpu/pairing/pairing.py` (its staged forms): multiply
the per-pair Miller values in Fq12, then ONE shared final exponentiation;
or, for a tuple whose second G2 point is a constant, the shared-squaring
two-pair Miller loop (`pairing_check2`). The port has no monolithic forms,
so each function here serves both of the JAX package's.
"""

from __future__ import annotations

import torch

from ..fields import limbs as L
from ..fields import tower as T
from . import final_exp as FE
from . import miller as M
from . import precompute as PC

Fq12 = T.Fq12


def pairing(px, py, qx, qy, inf_mask=None) -> Fq12:
    """Full pairing e(P, Q) for affine Montgomery-domain inputs."""
    return FE.final_exp(M.miller_loop(px, py, qx, qy, inf_mask))


def miller_product(px, py, qx, qy, pair_axis: int = 0) -> Fq12:
    """Miller values for a batch of pairs, multiplied along `pair_axis`.

    Inputs carry a leading 'pair' batch dim at tensor axis 1 (the first
    batch dim); the product reduces it.
    """
    f = M.miller_loop(px, py, qx, qy)
    return fq12_reduce_mul(f, axis=pair_axis)


def _cat_els(a, b, dim: int):
    """El-aware concat with merged (max) static bounds."""
    if isinstance(a, L.El):
        return L.El(torch.cat([a.arr, b.arr], dim=dim),
                    max(a.vmax, b.vmax), max(a.lmax, b.lmax))
    return type(a)(*[_cat_els(x, y, dim) for x, y in zip(a, b)])


def fq12_reduce_mul(f: Fq12, axis: int = 0) -> Fq12:
    """Tree-reduce an Fq12 batch axis by field multiplication.

    log2(n) sequential fq12_mul rounds, each on half the remaining batch;
    an odd leftover row rides along to the next round. `axis` indexes the
    batch dims (0 = tensor axis 1, after limbs).
    """
    taxis = axis + 1

    def take(sl):
        return lambda e: L.El(e.arr.narrow(taxis, sl.start, sl.stop - sl.start),
                              e.vmax, e.lmax)

    n = L.tree_leaves(f)[0].arr.shape[taxis]
    while n > 1:
        half = n // 2
        prod = T.fq12_mul(L.tree_map(take(slice(0, half)), f),
                          L.tree_map(take(slice(half, 2 * half)), f))
        if n % 2:
            rest = L.tree_map(take(slice(2 * half, n)), f)
            prod = _cat_els(prod, rest, taxis)
            n = half + 1
        else:
            n = half
        f = prod
    return L.tree_map(lambda e: L.El(e.arr.squeeze(taxis), e.vmax, e.lmax), f)


def pairing_check(px, py, qx, qy) -> torch.Tensor:
    """prod_i e(P_i, Q_i) == 1 with one shared final exponentiation.

    The pair axis is the first batch dim; remaining batch dims are kept.
    Returns a bool per remaining batch element.
    """
    f = M.miller_loop(px, py, qx, qy)
    reduced = T.fq12_retag(fq12_reduce_mul(f, axis=0))
    return T.fq12_is_one(FE.final_exp(reduced))


# ---------------------------------------------------------------------------
# 2-pair tuple check with a constant second G2 point (pair2)
# ---------------------------------------------------------------------------

# q_const -> the constant point's coefficient schedule
_CONST_COEFFS = {"neg_g2_one": PC.neg_g2_one_coeffs,
                 "g2_one": PC.g2_one_coeffs}


def _miller2(px0, py0, qx, qy, px1, py1, q_const: str = "neg_g2_one") -> Fq12:
    return M._miller_loop_pair2_unrolled(px0, py0, qx, qy, px1, py1,
                                         _CONST_COEFFS[q_const]())


def pairing_check2(px0, py0, qx, qy, px1, py1,
                   q_const: str = "neg_g2_one") -> torch.Tensor:
    """e(P0, Q0) * e(P1, Qc) == 1 per tuple, Qc = -G2::one ("neg_g2_one",
    verification) or +G2::one ("g2_one", the key-consistency check with the
    G1 side negated).

    One fq12_sq per digit per tuple, no device G2 arithmetic for the
    constant pair, no pair-axis product: the same per-tuple answers as
    stacking the two pairs through `pairing_check`. Its loop is the
    unrolled kernel form, which callers take on the card under
    `config.unroll_static_loops` only (`dist.batch_verify._use_pair2`)."""
    return T.fq12_is_one(
        FE.final_exp(_miller2(px0, py0, qx, qy, px1, py1, q_const)))
