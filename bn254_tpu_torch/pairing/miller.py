"""Optimal-ate Miller loop for BN254.

Counterpart of `bn254_tpu/pairing/miller.py`: its step bodies
(`_dbl_step_impl`, `_add_step_impl`, `_fq12_mul_line_impl`) with their
dispatchers (`_dbl_step`, `_add_step`, `fq12_mul_line`: one fused CUDA
kernel each on the card, kernels/fused.py), its bound pins, its unrolled
form `_miller_loop_unrolled` (one fused kernel per digit; the form CUDA
tensors take under `config.unroll_static_loops`), its scan form
`_miller_loop_scan`, here a Python loop over the static NAF schedule of
6u + 2 (CPU tensors, and CUDA tensors with the knob off, one kernel per
step op), and the shared-squaring two-pair form
`_miller_loop_pair2_unrolled` with its bodies `_dbl_body2_impl` and
`_add_body2_impl` (the independent tier on the card, pairing.pairing_check2).

* G2 points stay in homogeneous projective coordinates on the twist; line
  evaluations are division-free and scaled by subfield factors (killed by
  the final exponentiation).
* Lines have the sparse "034" shape l = A + B w + C w^3 (A, B, C in Fq2)
  and are folded with a dedicated sparse Fq12 multiplication.
* Everything is batched over trailing batch dims.

Line math (D-twist, tower w^2 = v, v^3 = xi):

  tangent at T=(X,Y,Z):  scale by 2YZ^2:
      A = -2YZ^2 * yP,  B = 3X^2 Z * xP,  C = 2Y^2 Z - 3X^3
  chord T,Q (Q affine):  theta = Y - yQ Z, lam = X - xQ Z, scale by lam:
      A = -lam * yP,    B = theta * xP,   C = lam yQ - theta xQ
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from ..constants import ATE_LOOP_COUNT, P, XI
from ..fields import limbs as L
from ..fields import tower as T
from ..host import field as HF
from ..kernels import fused as FK

Fq2 = T.Fq2
Fq6 = T.Fq6
Fq12 = T.Fq12


class ProjG2(NamedTuple):
    """Homogeneous projective point on the twist (x = X/Z, y = Y/Z)."""

    x: Fq2
    y: Fq2
    z: Fq2


# pi(x', y') = (conj(x') * XI^((p-1)/3), conj(y') * XI^((p-1)/2))
TWIST_FROB_X = HF.fq2_pow(XI, (P - 1) // 3)
TWIST_FROB_Y = HF.fq2_pow(XI, (P - 1) // 2)
# pi^2(x', y') = (x' * XI^((p^2-1)/3), y' * XI^((p^2-1)/2))
TWIST_FROB_X2 = HF.fq2_pow(XI, (P * P - 1) // 3)
TWIST_FROB_Y2 = HF.fq2_pow(XI, (P * P - 1) // 2)


# ---------------------------------------------------------------------------
# sparse Fq12 multiplication by a line A + B w + C v w
# ---------------------------------------------------------------------------


def _fq6_mul_by_01(g: Fq6, s0: Fq2, s1: Fq2) -> Fq6:
    """g * (s0 + s1 v): 5 Fq2 muls (Karatsuba on the low pair)."""
    t00 = T.fq2_mul(g.c0, s0)
    t11 = T.fq2_mul(g.c1, s1)
    u = T.fq2_mul(T.fq2_add(g.c0, g.c1), T.fq2_add(s0, s1))
    g2s0 = T.fq2_mul(g.c2, s0)
    g2s1 = T.fq2_mul(g.c2, s1)
    c0 = T.fq2_add(t00, T.fq2_mul_xi(g2s1))
    c1 = T.fq2_sub(T.fq2_sub(u, t00), t11)
    c2 = T.fq2_add(g2s0, t11)
    return T.fq6_squeeze(Fq6(c0, c1, c2))


def _fq6_mul_by_0(g: Fq6, s0: Fq2) -> Fq6:
    st = T.fq2_stack([g.c0, g.c1, g.c2])
    ss = T.fq2_stack([s0, s0, s0])
    p0, p1, p2 = T.fq2_unstack(T.fq2_mul(st, ss), 3)
    return Fq6(p0, p1, p2)


def _fq12_mul_line_impl(f: Fq12, a: Fq2, b: Fq2, c: Fq2) -> Fq12:
    """f * (A + B w + C v w) — Karatsuba: r0 = f0 A + v f1 (B + C v),
    r1 = (f0+f1)(A+B + C v) - f0 A - f1(B + C v)."""
    t0 = _fq6_mul_by_0(f.c0, a)
    t1 = _fq6_mul_by_01(f.c1, b, c)
    s = T.fq6_add(f.c0, f.c1)
    t2 = _fq6_mul_by_01(s, T.fq2_add(a, b), c)
    r0 = T.fq6_add(t0, T.fq6_mul_by_v(t1))
    r1 = T.fq6_sub(T.fq6_sub(t2, t0), t1)
    return T.fq12_squeeze(Fq12(r0, r1))


def fq12_mul_line(f: Fq12, a: Fq2, b: Fq2, c: Fq2) -> Fq12:
    """Sparse 034 line fold; one "fq12_mul_line" kernel launch on the card."""
    if T._use_kernels(*L.tree_leaves(f), a.c0, b.c0, c.c0):
        return FK.fused_op(_fq12_mul_line_impl, "fq12_mul_line", f, a, b, c)
    return _fq12_mul_line_impl(f, a, b, c)


# ---------------------------------------------------------------------------
# Miller loop steps
# ---------------------------------------------------------------------------


def _dbl_step(t: ProjG2, xp: L.El, yp: L.El):
    """Tangent-line doubling; one "g2_dbl_step" kernel launch on the card."""
    if T._use_kernels(t.x.c0, t.y.c0, t.z.c0, xp, yp):
        return FK.fused_op(_dbl_step_impl, "g2_dbl_step", t, xp, yp)
    return _dbl_step_impl(t, xp, yp)


def _dbl_step_impl(t: ProjG2, xp: L.El, yp: L.El):
    """Tangent-line doubling. Returns (2T, (A, B, C))."""
    X, Y, Z = t
    xx = T.fq2_sq(X)  # X^2
    yy = T.fq2_sq(Y)  # Y^2
    xy = T.fq2_mul(X, Y)
    yz = T.fq2_mul(Y, Z)

    x3 = T.fq2_mul(xx, X)  # X^3
    yyz = T.fq2_mul(yy, Z)  # Y^2 Z
    xyz = T.fq2_mul(xy, Z)  # XYZ
    xxz = T.fq2_mul(xx, Z)  # X^2 Z
    yzz = T.fq2_mul(yz, Z)  # Y Z^2

    # point: 2T = (2XYZ(9X^3-8Y^2Z) : 9X^3(4Y^2Z-3X^3) - 8(Y^2Z)^2 : 8(YZ)^3)
    nine_x3 = T.fq2_add(T.fq2_mul_small(x3, 8), x3)
    eight_yyz = T.fq2_mul_small(yyz, 8)
    x_out = T.fq2_double(T.fq2_mul(xyz, T.fq2_sub(nine_x3, eight_yyz)))
    y_out = T.fq2_sub(
        T.fq2_mul(nine_x3, T.fq2_sub(T.fq2_mul_small(yyz, 4),
                                     T.fq2_mul_small(x3, 3))),
        T.fq2_mul_small(T.fq2_sq(yyz), 8),
    )
    yz_sq = T.fq2_sq(yz)
    z_out = T.fq2_mul_small(T.fq2_mul(yz_sq, yz), 8)

    # line (scaled by 2YZ^2): A = -2YZ^2 yP ; B = 3X^2 Z xP ; C = 2Y^2Z - 3X^3
    a = T.fq2_mul_fq(T.fq2_neg(T.fq2_double(yzz)), yp)
    b = T.fq2_mul_fq(T.fq2_mul_small(xxz, 3), xp)
    c = T.fq2_sub(T.fq2_double(yyz), T.fq2_mul_small(x3, 3))
    return ProjG2(x_out, y_out, z_out), (a, b, c)


def _add_step(t: ProjG2, qx: Fq2, qy: Fq2, xp: L.El, yp: L.El):
    """Chord-line mixed addition; one "g2_add_step" kernel launch on the
    card."""
    if T._use_kernels(t.x.c0, qx.c0, qy.c0, xp, yp):
        return FK.fused_op(_add_step_impl, "g2_add_step", t, qx, qy, xp, yp)
    return _add_step_impl(t, qx, qy, xp, yp)


def _add_step_impl(t: ProjG2, qx: Fq2, qy: Fq2, xp: L.El, yp: L.El):
    """Chord-line mixed addition T + Q (Q affine). Returns (T+Q, (A,B,C))."""
    X, Y, Z = t
    theta = T.fq2_sub(Y, T.fq2_mul(qy, Z))
    lam = T.fq2_sub(X, T.fq2_mul(qx, Z))
    cc = T.fq2_sq(theta)
    dd = T.fq2_sq(lam)
    ee = T.fq2_mul(lam, dd)
    ff = T.fq2_mul(Z, cc)
    gg = T.fq2_mul(X, dd)
    hh = T.fq2_sub(T.fq2_add(ee, ff), T.fq2_double(gg))
    x_out = T.fq2_mul(lam, hh)
    y_out = T.fq2_sub(
        T.fq2_mul(theta, T.fq2_sub(gg, hh)), T.fq2_mul(ee, Y)
    )
    z_out = T.fq2_mul(Z, ee)

    # line (scaled by lam): A = -lam yP ; B = theta xP ; C = lam yQ - theta xQ
    a = T.fq2_mul_fq(T.fq2_neg(lam), yp)
    b = T.fq2_mul_fq(theta, xp)
    c = T.fq2_sub(T.fq2_mul(lam, qy), T.fq2_mul(theta, qx))
    return ProjG2(x_out, y_out, z_out), (a, b, c)


def _pin_el(e):
    """Force El bounds to the (STD_BOUND, 2^16) fixed point, value-reducing
    first when the static bound exceeds STD_BOUND (one leaf multiply,
    decided on the host), as the JAX package does for its loop carriers."""
    if e.vmax > L.STD_BOUND:
        e = L.vreduce(e)
    if e.lmax > (1 << 16):
        e = L.norm_limbs(e)
    return L.retag(e, L.STD_BOUND, 1 << 16)


def _pin_fq2(a: Fq2) -> Fq2:
    return Fq2(_pin_el(a.c0), _pin_el(a.c1))


def _pin_fq6(a: Fq6) -> Fq6:
    return Fq6(_pin_fq2(a.c0), _pin_fq2(a.c1), _pin_fq2(a.c2))


def _pin_fq12(a: Fq12) -> Fq12:
    return Fq12(_pin_fq6(a.c0), _pin_fq6(a.c1))


def _pin_proj(p: ProjG2) -> ProjG2:
    return ProjG2(_pin_fq2(p.x), _pin_fq2(p.y), _pin_fq2(p.z))


def _merge_fq2(take: Fq2, other: Fq2) -> Fq2:
    """`take` with the bounds a masked select of `take` and `other` would
    carry (the JAX scan's traced digit select, resolved on the host)."""
    return Fq2(*[
        L.El(t.arr, max(t.vmax, o.vmax), max(t.lmax, o.lmax))
        for t, o in zip(take, other)
    ])


def _twist_frob(qx: Fq2, qy: Fq2, power: int):
    """pi^power on affine twist coords (power in {1, 2})."""
    dev = qx.c0.device
    if power == 1:
        cx = T.const_fq2(TWIST_FROB_X, dev)
        cy = T.const_fq2(TWIST_FROB_Y, dev)
        return T.fq2_mul(T.fq2_conj(qx), cx), T.fq2_mul(T.fq2_conj(qy), cy)
    cx = T.const_fq2(TWIST_FROB_X2, dev)
    cy = T.const_fq2(TWIST_FROB_Y2, dev)
    return T.fq2_mul(qx, cx), T.fq2_mul(qy, cy)


def _naf(m: int):
    """Non-adjacent form, LSB first, digits in {-1, 0, 1}."""
    out = []
    while m:
        if m & 1:
            d = 2 - (m & 3)
            out.append(d)
            m -= d
        else:
            out.append(0)
        m >>= 1
    return out


# NAF of 6u+2, MSB-first with the leading digit consumed by T=Q, f=1.
_ATE_NAF = _naf(ATE_LOOP_COUNT)[::-1]
assert _ATE_NAF[0] == 1
_ATE_NAF = _ATE_NAF[1:]


# ---------------------------------------------------------------------------
# fused step bodies: the whole per-digit Miller work as ONE kernel launch
# ---------------------------------------------------------------------------


def _dbl_body_impl(f: Fq12, t: ProjG2, xp: L.El, yp: L.El):
    """sq + tangent double + sparse line fold (kernel "miller_dbl_body")."""
    f = T.fq12_sq(f)
    t2, (a, b, c) = _dbl_step_impl(t, xp, yp)
    f = _fq12_mul_line_impl(f, a, b, c)
    return _pin_fq12(f), _pin_proj(t2)


def _add_body_impl(f: Fq12, t: ProjG2, qx: Fq2, qy: Fq2, xp: L.El,
                   yp: L.El):
    """chord add + sparse line fold (kernel "miller_add_body")."""
    t2, (a, b, c) = _add_step_impl(t, qx, qy, xp, yp)
    f = _fq12_mul_line_impl(f, a, b, c)
    return _pin_fq12(f), _pin_proj(t2)


def _miller_loop_unrolled(xp, yp, qx: Fq2, qy: Fq2, inf_mask=None,
                          naf=None) -> Fq12:
    """The Miller loop unrolled over the STATIC NAF schedule: one
    `miller_dbl_body` launch per digit, one `miller_add_body` launch per
    nonzero digit and per Frobenius step (65 + 23 on the full schedule).

    Every operand is pinned to (STD_BOUND, 2^16) once before the loop and
    every body pins its outputs, so each launch sees the same bounds.
    naf: digit schedule override (tests use a truncated prefix).
    """
    batch = torch.broadcast_shapes(xp.batch_shape, qx.c0.batch_shape)
    dev = xp.device
    f = _pin_fq12(T.fq12_one(batch, dev))
    t = _pin_proj(ProjG2(qx, qy, T.fq2_one(batch, dev)))
    pqx, pqy = _pin_fq2(qx), _pin_fq2(qy)
    nqy = _pin_fq2(T.fq2_neg(qy))
    xpp, ypp = _pin_el(xp), _pin_el(yp)

    for d in (_ATE_NAF if naf is None else naf):
        f, t = FK.fused_op(_dbl_body_impl, "miller_dbl_body", f, t, xpp, ypp)
        if d != 0:
            f, t = FK.fused_op(_add_body_impl, "miller_add_body", f, t, pqx,
                               pqy if d > 0 else nqy, xpp, ypp)

    q1x, q1y = _twist_frob(pqx, pqy, 1)
    q2x, q2y = _twist_frob(pqx, pqy, 2)
    for ax, ay in ((q1x, q1y), (q2x, T.fq2_neg(q2y))):
        f, t = FK.fused_op(_add_body_impl, "miller_add_body", f, t,
                           _pin_fq2(ax), _pin_fq2(ay), xpp, ypp)

    if inf_mask is not None:
        f = T.fq12_select(inf_mask, T.fq12_one(batch, dev), f)
    return f


# ---------------------------------------------------------------------------
# shared-squaring 2-pair Miller loop with a constant-Q second pair
# ---------------------------------------------------------------------------


def _dbl_body2_impl(f: Fq12, t: ProjG2, xp0: L.El, yp0: L.El, ca: Fq2,
                    cb: Fq2, cc: Fq2, xp1: L.El, yp1: L.El):
    """One doubling digit for BOTH pairs of a tuple under ONE shared
    accumulator squaring: sq + pair-0 tangent double and fold + pair-1
    precomputed constant-line fold (kernel "miller_dbl_body2").

    Valid because every pair's recurrence is f_i <- f_i^2 * l_i, so the
    product satisfies (prod f_i) <- (prod f_i)^2 * prod l_i."""
    f = T.fq12_sq(f)
    t2, (a, b, c) = _dbl_step_impl(t, xp0, yp0)
    f = _fq12_mul_line_impl(f, a, b, c)
    a1 = T.fq2_mul_fq(ca, yp1)
    b1 = T.fq2_mul_fq(cb, xp1)
    f = _fq12_mul_line_impl(f, a1, b1, cc)
    return _pin_fq12(f), _pin_proj(t2)


def _add_body2_impl(f: Fq12, t: ProjG2, qx: Fq2, qy: Fq2, xp0: L.El,
                    yp0: L.El, ca: Fq2, cb: Fq2, cc: Fq2, xp1: L.El,
                    yp1: L.El):
    """One addition digit for both pairs (no squaring on adds; kernel
    "miller_add_body2")."""
    t2, (a, b, c) = _add_step_impl(t, qx, qy, xp0, yp0)
    f = _fq12_mul_line_impl(f, a, b, c)
    a1 = T.fq2_mul_fq(ca, yp1)
    b1 = T.fq2_mul_fq(cb, xp1)
    f = _fq12_mul_line_impl(f, a1, b1, cc)
    return _pin_fq12(f), _pin_proj(t2)


@functools.lru_cache(maxsize=None)
def _const_lines(coeffs: tuple, device: torch.device) -> tuple:
    """A coefficient schedule as (kind, ca, cb, cc) with pinned (18,)
    device Fq2s, made once per (schedule, device): the JAX package folds
    them into its trace, and converting the 264 constants on every call
    would put as many small host-to-device copies on the path."""
    return tuple(
        (kind, *[_pin_fq2(T.const_fq2(c, device)) for c in (ca, cb, cc)])
        for kind, ca, cb, cc in coeffs)


def _miller_loop_pair2_unrolled(xp0, yp0, qx: Fq2, qy: Fq2, xp1, yp1,
                                coeffs, naf=None) -> Fq12:
    """miller(P0, Q0) * miller(P1, Qc) with Qc a host constant.

    Unrolled over the static NAF schedule like `_miller_loop_unrolled`, but
    each launch advances BOTH pairs of a tuple: pair 0 (variable Q0, a
    public key) does the full tangent/chord step; pair 1 (constant Qc, e.g.
    -G2::one) folds a line from host-precomputed coefficients
    (pairing/precompute.py). One `miller_dbl_body2` launch per digit, one
    `miller_add_body2` per nonzero digit and per Frobenius step (65 + 23 on
    the full schedule).

    coeffs: `precompute.g2_line_coeffs(Qc_affine, naf)` output; its launch
    order is asserted against this loop's digit schedule.
    """
    batch = torch.broadcast_shapes(xp0.batch_shape, qx.c0.batch_shape,
                                   xp1.batch_shape)
    dev = xp0.device
    f = _pin_fq12(T.fq12_one(batch, dev))
    t = _pin_proj(ProjG2(qx, qy, T.fq2_one(batch, dev)))
    pqx, pqy = _pin_fq2(qx), _pin_fq2(qy)
    nqy = _pin_fq2(T.fq2_neg(qy))
    xpp0, ypp0 = _pin_el(xp0), _pin_el(yp0)
    xpp1, ypp1 = _pin_el(xp1), _pin_el(yp1)

    def const3(entry, kind):
        k, ca, cb, cc = entry
        assert k == kind, f"coeff schedule mismatch: {k} != {kind}"
        return ca, cb, cc

    it = iter(_const_lines(tuple(coeffs), dev))
    for d in (_ATE_NAF if naf is None else naf):
        ca, cb, cc = const3(next(it), "dbl")
        f, t = FK.fused_op(_dbl_body2_impl, "miller_dbl_body2",
                           f, t, xpp0, ypp0, ca, cb, cc, xpp1, ypp1)
        if d != 0:
            ca, cb, cc = const3(next(it), "add")
            f, t = FK.fused_op(_add_body2_impl, "miller_add_body2",
                               f, t, pqx, pqy if d > 0 else nqy,
                               xpp0, ypp0, ca, cb, cc, xpp1, ypp1)

    q1x, q1y = _twist_frob(pqx, pqy, 1)
    q2x, q2y = _twist_frob(pqx, pqy, 2)
    for ax, ay in ((q1x, q1y), (q2x, T.fq2_neg(q2y))):
        ca, cb, cc = const3(next(it), "add")
        f, t = FK.fused_op(_add_body2_impl, "miller_add_body2",
                           f, t, _pin_fq2(ax), _pin_fq2(ay),
                           xpp0, ypp0, ca, cb, cc, xpp1, ypp1)
    assert next(it, None) is None, "unconsumed precomputed coefficients"
    return f


def miller_loop(xp, yp, qx: Fq2, qy: Fq2, inf_mask=None, naf=None) -> Fq12:
    """f_{6u+2, Q}(P) with Frobenius addition steps.

    xp, yp: affine G1 coords, Montgomery limb Els (18, *batch).
    qx, qy: affine twist G2 coords (tower.Fq2).
    inf_mask: optional batch bool — where True the output is forced to 1
    (matching `pairing(identity, ·) == 1`).
    naf: digit schedule override (tests use a truncated prefix).

    On CUDA tensors under `config.unroll_static_loops` the loop is
    `_miller_loop_unrolled` (one kernel per digit); otherwise
    `_miller_loop_scan`, as the JAX package dispatches between its two
    forms.
    """
    from .. import config as C

    if C.DEFAULT.unroll_static_loops and T._use_kernels(xp, yp, qx.c0,
                                                         qy.c0):
        return _miller_loop_unrolled(xp, yp, qx, qy, inf_mask, naf)
    return _miller_loop_scan(xp, yp, qx, qy, inf_mask, naf)


def _miller_loop_scan(xp, yp, qx: Fq2, qy: Fq2, inf_mask=None,
                      naf=None) -> Fq12:
    """The per-op loop, the counterpart of JAX's `_miller_loop_scan`.

    Every digit squares and doubles; nonzero digits add Q (digit 1) or -Q
    (digit -1). Each step op dispatches on its own (`T.fq12_sq`,
    `_dbl_step`, `_add_step`, `fq12_mul_line`): on the card four kernels
    per doubling digit and two per addition, 65/23/88/65 on the full
    schedule. Carriers are pinned on both branches, exactly as the JAX scan
    does, so the limbs match it one for one.
    """
    batch, dev = xp.batch_shape, xp.device
    f = _pin_fq12(T.fq12_one(batch, dev))
    t = _pin_proj(ProjG2(qx, qy, T.fq2_one(batch, dev)))
    nqy = _pin_fq2(T.fq2_neg(qy))

    for d in (_ATE_NAF if naf is None else naf):
        f = T.fq12_sq(f)
        t, (la, lb, lc) = _dbl_step(t, xp, yp)
        f = fq12_mul_line(f, la, lb, lc)
        if d != 0:
            qy_eff = _merge_fq2(qy, nqy) if d > 0 else _merge_fq2(nqy, qy)
            t, (la, lb, lc) = _add_step(t, qx, qy_eff, xp, yp)
            f = fq12_mul_line(f, la, lb, lc)
        f, t = _pin_fq12(f), _pin_proj(t)

    # Frobenius addition steps: +Q1, then +(-Q2)
    q1x, q1y = _twist_frob(qx, qy, 1)
    q2x, q2y = _twist_frob(qx, qy, 2)
    nq2y = T.fq2_neg(q2y)

    t, (la, lb, lc) = _add_step(t, q1x, q1y, xp, yp)
    f = fq12_mul_line(f, la, lb, lc)
    t, (la, lb, lc) = _add_step(t, q2x, nq2y, xp, yp)
    f = fq12_mul_line(f, la, lb, lc)

    if inf_mask is not None:
        f = T.fq12_select(inf_mask, T.fq12_one(batch, dev), f)
    return f
