"""Host-side G2 line coefficients for constant-Q pairings.

Counterpart of `bn254_tpu/pairing/precompute.py` (framework-free, so the
port keeps its own copy). In BLS verification every tuple's second pair is
e(sig, -G2::one), and in the key-consistency check it is e(-pk1, G2::one):
the G2 argument is a constant. The G2-side point arithmetic of the Miller
loop then depends on nothing but Q and runs ONCE on the host; per tuple
the device only evaluates each precomputed line at P:

    l = (ca * yP) + (cb * xP) w + cc v w

with (ca, cb, cc) constant Fq2 triples, one per line fold of the fixed
NAF schedule of 6u+2 (65 doublings + 21 NAF adds + 2 Frobenius adds).

The iteration mirrors miller._dbl_step_impl / miller._add_step_impl
exactly (same projective formulas, same scaling factors), so the pair
folding a precomputed line folds the very line it would have computed
itself.
"""

from __future__ import annotations

import functools

from ..constants import P
from ..host import curve as HC
from ..host import field as HF
from . import miller as M


def _smul(a, k: int):
    return ((a[0] * k) % P, (a[1] * k) % P)


def _conj(a):
    return (a[0], (-a[1]) % P)


def g2_line_coeffs(q_affine, naf=None):
    """Per-launch line-coefficient triples for a constant twist point.

    q_affine: affine E'(Fq2) point as ((x0, x1), (y0, y1)) host ints.
    naf: schedule override (tests use a truncated prefix; it must match the
    naf= given to the device loop).

    Returns a list, in the unrolled loop's launch order, of
    (kind, ca, cb, cc) with kind in {"dbl", "add"} and ca/cb/cc host Fq2
    int pairs: for each NAF digit a "dbl" entry, then an "add" entry if the
    digit is nonzero; finally the two Frobenius "add" entries.
    """
    qx, qy = q_affine
    state = [qx, qy, HF.FQ2_ONE]  # X, Y, Z on the twist
    out = []

    def dbl():
        X, Y, Z = state
        xx = HF.fq2_sq(X)
        yy = HF.fq2_sq(Y)
        xy = HF.fq2_mul(X, Y)
        yz = HF.fq2_mul(Y, Z)
        x3 = HF.fq2_mul(xx, X)
        yyz = HF.fq2_mul(yy, Z)
        xyz = HF.fq2_mul(xy, Z)
        xxz = HF.fq2_mul(xx, Z)
        yzz = HF.fq2_mul(yz, Z)
        nine_x3 = _smul(x3, 9)
        state[0] = _smul(
            HF.fq2_mul(xyz, HF.fq2_sub(nine_x3, _smul(yyz, 8))), 2
        )
        state[1] = HF.fq2_sub(
            HF.fq2_mul(nine_x3, HF.fq2_sub(_smul(yyz, 4), _smul(x3, 3))),
            _smul(HF.fq2_sq(yyz), 8),
        )
        state[2] = _smul(HF.fq2_mul(HF.fq2_sq(yz), yz), 8)
        ca = HF.fq2_neg(_smul(yzz, 2))
        cb = _smul(xxz, 3)
        cc = HF.fq2_sub(_smul(yyz, 2), _smul(x3, 3))
        out.append(("dbl", ca, cb, cc))

    def add(ax, ay):
        X, Y, Z = state
        theta = HF.fq2_sub(Y, HF.fq2_mul(ay, Z))
        lam = HF.fq2_sub(X, HF.fq2_mul(ax, Z))
        c2 = HF.fq2_sq(theta)
        d2 = HF.fq2_sq(lam)
        ee = HF.fq2_mul(lam, d2)
        ff = HF.fq2_mul(Z, c2)
        gg = HF.fq2_mul(X, d2)
        hh = HF.fq2_sub(HF.fq2_add(ee, ff), _smul(gg, 2))
        state[0] = HF.fq2_mul(lam, hh)
        state[1] = HF.fq2_sub(
            HF.fq2_mul(theta, HF.fq2_sub(gg, hh)), HF.fq2_mul(ee, Y)
        )
        state[2] = HF.fq2_mul(Z, ee)
        ca = HF.fq2_neg(lam)
        cb = theta
        cc = HF.fq2_sub(HF.fq2_mul(lam, ay), HF.fq2_mul(theta, ax))
        out.append(("add", ca, cb, cc))

    nqy = HF.fq2_neg(qy)
    for d in (M._ATE_NAF if naf is None else naf):
        dbl()
        if d != 0:
            add(qx, qy if d > 0 else nqy)

    # Frobenius addition steps: +pi(Q), then +(-pi^2(Q)), with the twist
    # constants miller._twist_frob uses
    q1x = HF.fq2_mul(_conj(qx), M.TWIST_FROB_X)
    q1y = HF.fq2_mul(_conj(qy), M.TWIST_FROB_Y)
    q2x = HF.fq2_mul(qx, M.TWIST_FROB_X2)
    q2y = HF.fq2_mul(qy, M.TWIST_FROB_Y2)
    add(q1x, q1y)
    add(q2x, HF.fq2_neg(q2y))
    return out


@functools.lru_cache(maxsize=None)
def neg_g2_one_coeffs():
    """Coefficients for Q = -G2::one, the constant second pair of the
    verification equation."""
    return g2_line_coeffs(HC.g2_to_affine(HC.g2_neg(HC.G2_ONE)))


@functools.lru_cache(maxsize=None)
def g2_one_coeffs():
    """Coefficients for Q = +G2::one, the constant second pair of the
    key-consistency check (with the G1 side negated)."""
    return g2_line_coeffs(HC.g2_to_affine(HC.G2_ONE))
