"""Host-side (pure Python int) elliptic-curve group arithmetic for BN254.

G1: E/Fq  : y^2 = x^3 + 3
G2: E'/Fq2: y^2 = x^3 + 3/xi   (D-type sextic twist, xi = 9 + i)

Points are represented in Jacobian coordinates (X, Y, Z) with the identity
encoded as Z = 0 (mirroring the reference dependency's internal Jacobian
representation, evidenced by the `PointInJacobian` error at
reference src/error.rs:21-22).  Affine values are (x, y) pairs; the
identity in affine context is `None`.
"""

from __future__ import annotations

from ..constants import B, G1_GEN, G2_GEN_X, G2_GEN_Y, P, R
from . import field as F

# ---------------------------------------------------------------------------
# Generic Jacobian arithmetic over a field given by an ops record
# ---------------------------------------------------------------------------


class _FieldOps:
    """Minimal field-op bundle so G1 (Fq) and G2 (Fq2) share one code path."""

    __slots__ = ("add", "sub", "mul", "sq", "neg", "inv", "zero", "one", "is_zero", "scalar")

    def __init__(self, add, sub, mul, sq, neg, inv, zero, one, is_zero, scalar):
        self.add, self.sub, self.mul, self.sq = add, sub, mul, sq
        self.neg, self.inv, self.zero, self.one = neg, inv, zero, one
        self.is_zero, self.scalar = is_zero, scalar


FQ_OPS = _FieldOps(
    add=F.fq_add,
    sub=F.fq_sub,
    mul=F.fq_mul,
    sq=lambda a: (a * a) % P,
    neg=F.fq_neg,
    inv=F.fq_inv,
    zero=0,
    one=1,
    is_zero=lambda a: a % P == 0,
    scalar=lambda a, k: (a * k) % P,
)

FQ2_OPS = _FieldOps(
    add=F.fq2_add,
    sub=F.fq2_sub,
    mul=F.fq2_mul,
    sq=F.fq2_sq,
    neg=F.fq2_neg,
    inv=F.fq2_inv,
    zero=F.FQ2_ZERO,
    one=F.FQ2_ONE,
    is_zero=F.fq2_is_zero,
    scalar=F.fq2_scalar_mul,
)

# Curve b coefficients
B1 = B  # G1: y^2 = x^3 + 3
B2 = F.fq2_mul(F.fq2_scalar_mul(F.FQ2_ONE, B), F.fq2_inv(F.fq2_add((9, 0), (0, 1))))  # 3/xi


def jac_is_identity(pt, ops: _FieldOps) -> bool:
    return ops.is_zero(pt[2])


def jac_double(pt, ops: _FieldOps):
    X, Y, Z = pt
    if ops.is_zero(Z) or ops.is_zero(Y):
        return (ops.one, ops.one, ops.zero)
    # dbl-2009-l (a = 0)
    A = ops.sq(X)
    Bv = ops.sq(Y)
    C = ops.sq(Bv)
    D = ops.scalar(ops.sub(ops.sq(ops.add(X, Bv)), ops.add(A, C)), 2)
    E = ops.scalar(A, 3)
    Fv = ops.sq(E)
    X3 = ops.sub(Fv, ops.scalar(D, 2))
    Y3 = ops.sub(ops.mul(E, ops.sub(D, X3)), ops.scalar(C, 8))
    Z3 = ops.scalar(ops.mul(Y, Z), 2)
    return (X3, Y3, Z3)


def jac_add(p1, p2, ops: _FieldOps):
    if jac_is_identity(p1, ops):
        return p2
    if jac_is_identity(p2, ops):
        return p1
    X1, Y1, Z1 = p1
    X2, Y2, Z2 = p2
    Z1Z1 = ops.sq(Z1)
    Z2Z2 = ops.sq(Z2)
    U1 = ops.mul(X1, Z2Z2)
    U2 = ops.mul(X2, Z1Z1)
    S1 = ops.mul(ops.mul(Y1, Z2), Z2Z2)
    S2 = ops.mul(ops.mul(Y2, Z1), Z1Z1)
    if ops.is_zero(ops.sub(U1, U2)):
        if ops.is_zero(ops.sub(S1, S2)):
            return jac_double(p1, ops)
        return (ops.one, ops.one, ops.zero)  # P + (-P) = identity
    H = ops.sub(U2, U1)
    I = ops.sq(ops.scalar(H, 2))
    J = ops.mul(H, I)
    r = ops.scalar(ops.sub(S2, S1), 2)
    V = ops.mul(U1, I)
    X3 = ops.sub(ops.sub(ops.sq(r), J), ops.scalar(V, 2))
    Y3 = ops.sub(ops.mul(r, ops.sub(V, X3)), ops.scalar(ops.mul(S1, J), 2))
    Z3 = ops.scalar(ops.mul(ops.mul(Z1, Z2), H), 2)
    return (X3, Y3, Z3)


def jac_neg(pt, ops: _FieldOps):
    return (pt[0], ops.neg(pt[1]), pt[2])


def jac_scalar_mul(pt, k: int, ops: _FieldOps):
    # NB: k is NOT reduced mod r here — reduction is only sound for points
    # already known to lie in the r-torsion, and the subgroup check itself
    # relies on computing a genuine [r]P.
    if k < 0:
        return jac_scalar_mul(jac_neg(pt, ops), -k, ops)
    result = (ops.one, ops.one, ops.zero)
    addend = pt
    while k:
        if k & 1:
            result = jac_add(result, addend, ops)
        addend = jac_double(addend, ops)
        k >>= 1
    return result


def jac_to_affine(pt, ops: _FieldOps):
    X, Y, Z = pt
    if ops.is_zero(Z):
        return None
    zinv = ops.inv(Z)
    zinv2 = ops.sq(zinv)
    return (ops.mul(X, zinv2), ops.mul(ops.mul(Y, zinv), zinv2))


def affine_to_jac(aff, ops: _FieldOps):
    if aff is None:
        return (ops.one, ops.one, ops.zero)
    return (aff[0], aff[1], ops.one)


def jac_eq(p1, p2, ops: _FieldOps) -> bool:
    """Equality of Jacobian points (compare in affine)."""
    return jac_to_affine(p1, ops) == jac_to_affine(p2, ops)


# ---------------------------------------------------------------------------
# G1 wrappers
# ---------------------------------------------------------------------------

G1_ONE = (G1_GEN[0], G1_GEN[1], 1)
G1_IDENTITY = (1, 1, 0)


def g1_add(a, b):
    return jac_add(a, b, FQ_OPS)


def g1_double(a):
    return jac_double(a, FQ_OPS)


def g1_neg(a):
    return jac_neg(a, FQ_OPS)


def _native() -> bool:
    """True when the C++ host core (csrc/, `native.py`) is to be used. The
    hot wrappers below dispatch to it; the pure-Python `jac_*` functions
    remain the oracle and are reachable via the `*_py` aliases."""
    from . import native as N

    return N.available()


def g1_mul(a, k: int):
    if k >= 0 and _native():
        from . import native as N

        return affine_to_jac(N.g1_mul(jac_to_affine(a, FQ_OPS), k), FQ_OPS)
    return jac_scalar_mul(a, k, FQ_OPS)


def g1_mul_py(a, k: int):
    """Pure-Python scalar mul (oracle path, native never consulted)."""
    return jac_scalar_mul(a, k, FQ_OPS)


def g1_to_affine(a):
    return jac_to_affine(a, FQ_OPS)


def g1_from_affine(aff):
    return affine_to_jac(aff, FQ_OPS)


def g1_eq(a, b) -> bool:
    return jac_eq(a, b, FQ_OPS)


def g1_is_on_curve(aff) -> bool:
    """Affine on-curve check for G1 (cofactor 1 ⇒ also subgroup membership)."""
    if aff is None:
        return True
    x, y = aff
    return (y * y - (x * x * x + B1)) % P == 0


# ---------------------------------------------------------------------------
# G2 wrappers
# ---------------------------------------------------------------------------

G2_ONE = (G2_GEN_X, G2_GEN_Y, F.FQ2_ONE)
G2_IDENTITY = (F.FQ2_ONE, F.FQ2_ONE, F.FQ2_ZERO)


def g2_add(a, b):
    return jac_add(a, b, FQ2_OPS)


def g2_double(a):
    return jac_double(a, FQ2_OPS)


def g2_neg(a):
    return jac_neg(a, FQ2_OPS)


def g2_mul(a, k: int):
    if k >= 0 and _native():
        from . import native as N

        return affine_to_jac(N.g2_mul(jac_to_affine(a, FQ2_OPS), k), FQ2_OPS)
    return jac_scalar_mul(a, k, FQ2_OPS)


def g2_mul_py(a, k: int):
    """Pure-Python scalar mul (oracle path, native never consulted)."""
    return jac_scalar_mul(a, k, FQ2_OPS)


def g2_to_affine(a):
    return jac_to_affine(a, FQ2_OPS)


def g2_from_affine(aff):
    return affine_to_jac(aff, FQ2_OPS)


def g2_eq(a, b) -> bool:
    return jac_eq(a, b, FQ2_OPS)


def g2_is_on_curve(aff) -> bool:
    if aff is None:
        return True
    x, y = aff
    lhs = F.fq2_sq(y)
    rhs = F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), B2)
    return F.fq2_is_zero(F.fq2_sub(lhs, rhs))


def g2_is_in_subgroup(aff) -> bool:
    """Subgroup check: [r]P == identity (G2 has a nontrivial cofactor)."""
    if aff is None:
        return True
    if _native():
        from . import native as N

        return N.g2_in_subgroup(aff)
    pt = g2_from_affine(aff)
    return jac_is_identity(jac_scalar_mul(pt, R, FQ2_OPS), FQ2_OPS)
