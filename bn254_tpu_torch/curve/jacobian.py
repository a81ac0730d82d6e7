"""Branch-free batched Jacobian curve arithmetic.

Counterpart of `bn254_tpu/curve/jacobian.py`: one generic implementation
for G1 (Fq coords) and G2 (Fq2 coords). Identity handling, the P == Q
doubling case and P == -Q cancellation are masked selects, so a point add
is one straight-line tensor program with no host synchronisation. The
identity is Z == 0. Formulas: dbl-2009-l and add-2007-bl (a = 0 curves),
the host oracle's.
"""

from __future__ import annotations

from typing import NamedTuple

from ..constants import LIMB_BITS


class JPoint(NamedTuple):
    """Jacobian point; coords are field elements of the instantiating ops."""

    x: object
    y: object
    z: object


def identity(ops, batch_shape=(), device="cpu") -> JPoint:
    one = ops.one(batch_shape, device)
    return JPoint(one, one, ops.zero(batch_shape, device))


def is_identity(ops, p: JPoint):
    return ops.is_zero(p.z)


def neg(ops, p: JPoint) -> JPoint:
    return JPoint(p.x, ops.neg(p.y), p.z)


def double(ops, p: JPoint) -> JPoint:
    """dbl-2009-l; maps the identity to the identity (Z stays 0)."""
    a = ops.sq(p.x)
    b = ops.sq(p.y)
    c = ops.sq(b)
    d = ops.double(ops.sub(ops.sq(ops.add(p.x, b)), ops.add(a, c)))
    e = ops.mul_small(a, 3)
    f = ops.sq(e)
    x3 = ops.sub(f, ops.double(d))
    y3 = ops.sub(ops.mul(e, ops.sub(d, x3)), ops.mul_small(c, 8))
    z3 = ops.double(ops.mul(p.y, p.z))
    return JPoint(x3, y3, z3)


def add(ops, p1: JPoint, p2: JPoint) -> JPoint:
    """Complete (branch-free) addition via add-2007-bl + masked selects."""
    z1z1 = ops.sq(p1.z)
    z2z2 = ops.sq(p2.z)
    u1 = ops.mul(p1.x, z2z2)
    u2 = ops.mul(p2.x, z1z1)
    s1 = ops.mul(ops.mul(p1.y, p2.z), z2z2)
    s2 = ops.mul(ops.mul(p2.y, p1.z), z1z1)

    h = ops.sub(u2, u1)
    r = ops.double(ops.sub(s2, s1))

    i = ops.sq(ops.double(h))
    j = ops.mul(h, i)
    v = ops.mul(u1, i)
    x3 = ops.sub(ops.sub(ops.sq(r), j), ops.double(v))
    y3 = ops.sub(ops.mul(r, ops.sub(v, x3)), ops.double(ops.mul(s1, j)))
    z3 = ops.double(ops.mul(ops.mul(p1.z, p2.z), h))
    added = JPoint(x3, y3, z3)

    # Edge cases, resolved innermost-first:
    #   same x, same y      -> doubling
    #   same x, different y -> identity (P + (-P))
    #   p1 identity -> p2 ; p2 identity -> p1
    h_zero = ops.is_zero(h)
    r_zero = ops.is_zero(r)
    doubled = double(ops, p1)
    idp = identity(ops, ops.batch_shape(p1.x), ops.device(p1.x))

    result = _select_point(ops, h_zero & r_zero, doubled, added)
    result = _select_point(ops, h_zero & ~r_zero, idp, result)
    result = _select_point(ops, is_identity(ops, p1), p2, result)
    result = _select_point(ops, is_identity(ops, p2), p1, result)
    return result


def _select_point(ops, mask, t: JPoint, f: JPoint) -> JPoint:
    return JPoint(
        ops.select(mask, t.x, f.x),
        ops.select(mask, t.y, f.y),
        ops.select(mask, t.z, f.z),
    )


def _retag_point(ops, p: JPoint, vmax: int) -> JPoint:
    """Pin carrier bounds (value AND limb) for loop-carrier stability."""
    return JPoint(
        ops.retag(p.x, vmax), ops.retag(p.y, vmax), ops.retag(p.z, vmax)
    )


def scalar_mul(ops, p: JPoint, scalar_limbs, nbits: int = 256) -> JPoint:
    """[k]P by a fixed nbits-step LSB-first double-and-add ladder.

    scalar_limbs: El (or tensor) with canonical little-endian limbs of k
    (k < 2^nbits). Constant iteration count and branch-free accumulation
    (masked select), so the schedule is data-independent.
    """
    from ..fields.limbs import El, STD_BOUND

    s_arr = scalar_limbs.arr if isinstance(scalar_limbs, El) else scalar_limbs
    acc = _retag_point(
        ops, identity(ops, ops.batch_shape(p.x), ops.device(p.x)), STD_BOUND)
    addend = _retag_point(ops, p, STD_BOUND)
    for i in range(nbits):
        bit = (s_arr[i // LIMB_BITS] >> (i % LIMB_BITS)) & 1
        summed = add(ops, acc, addend)
        acc = _retag_point(
            ops, _select_point(ops, bit != 0, summed, acc), STD_BOUND)
        addend = _retag_point(ops, double(ops, addend), STD_BOUND)
    return acc


def eq(ops, p1: JPoint, p2: JPoint):
    """Projective equality: X1 Z2^2 == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3,
    with identity flags compared separately."""
    i1 = is_identity(ops, p1)
    i2 = is_identity(ops, p2)
    z1z1 = ops.sq(p1.z)
    z2z2 = ops.sq(p2.z)
    x_eq = ops.eq(ops.mul(p1.x, z2z2), ops.mul(p2.x, z1z1))
    y_eq = ops.eq(
        ops.mul(ops.mul(p1.y, p2.z), z2z2), ops.mul(ops.mul(p2.y, p1.z), z1z1)
    )
    both_fin = (~i1) & (~i2) & x_eq & y_eq
    return (i1 & i2) | both_fin


def to_affine(ops, p: JPoint):
    """-> (x, y, infinity_mask). Identity maps to (0, 0, True)."""
    bs = ops.batch_shape(p.x)
    dev = ops.device(p.x)
    inf = is_identity(ops, p)
    safe_z = ops.select(inf, ops.one(bs, dev), p.z)
    zinv = ops.inv(safe_z)
    zinv2 = ops.sq(zinv)
    x = ops.mul(p.x, zinv2)
    y = ops.mul(ops.mul(p.y, zinv), zinv2)
    zero = ops.zero(bs, dev)
    return ops.select(inf, zero, x), ops.select(inf, zero, y), inf


def from_affine(ops, x, y, inf_mask=None) -> JPoint:
    """Affine coords (and an optional identity mask) -> Jacobian, Z = 1."""
    bs = ops.batch_shape(x)
    dev = ops.device(x)
    z = ops.one(bs, dev)
    if inf_mask is not None:
        z = ops.select(inf_mask, ops.zero(bs, dev), z)
    return JPoint(x, y, z)
