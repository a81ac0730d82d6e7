"""Host-side (pure Python int) tower-field arithmetic for BN254.

This module is the *oracle*: a simple, obviously-correct implementation of
Fq, Fq2 = Fq[i]/(i^2+1), Fq6 = Fq2[v]/(v^3 - xi), Fq12 = Fq6[w]/(w^2 - v)
used to (a) validate the device limb kernels against random and golden vectors,
and (b) serve the single-operation host paths of the protocol API (the same
role the Rust `zeropool-bn` dependency plays for the reference; SURVEY.md §2.3).

Representation:
    Fq   : int in [0, p)
    Fq2  : tuple (c0, c1)           meaning c0 + c1*i
    Fq6  : tuple (a0, a1, a2)       of Fq2, meaning a0 + a1*v + a2*v^2
    Fq12 : tuple (b0, b1)           of Fq6, meaning b0 + b1*w
"""

from __future__ import annotations

from ..constants import P, XI

# ---------------------------------------------------------------------------
# Fq
# ---------------------------------------------------------------------------


def fq_add(a: int, b: int) -> int:
    return (a + b) % P


def fq_sub(a: int, b: int) -> int:
    return (a - b) % P


def fq_mul(a: int, b: int) -> int:
    return (a * b) % P


def fq_neg(a: int) -> int:
    return (-a) % P


def fq_inv(a: int) -> int:
    if a % P == 0:
        raise ZeroDivisionError("inverse of zero in Fq")
    return pow(a, -1, P)


def fq_sqrt(a: int) -> int | None:
    """Square root in Fq (p ≡ 3 mod 4), or None if a is not a QR."""
    a %= P
    s = pow(a, (P + 1) // 4, P)
    return s if (s * s) % P == a else None


# ---------------------------------------------------------------------------
# Fq2 = Fq[i] / (i^2 + 1)
# ---------------------------------------------------------------------------

FQ2_ZERO = (0, 0)
FQ2_ONE = (1, 0)


def fq2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def fq2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def fq2_neg(a):
    return ((-a[0]) % P, (-a[1]) % P)


def fq2_mul(a, b):
    # (a0 + a1 i)(b0 + b1 i) = (a0b0 - a1b1) + (a0b1 + a1b0) i
    t0 = a[0] * b[0]
    t1 = a[1] * b[1]
    t2 = (a[0] + a[1]) * (b[0] + b[1])
    return ((t0 - t1) % P, (t2 - t0 - t1) % P)


def fq2_sq(a):
    # (a0 + a1 i)^2 = (a0+a1)(a0-a1) + 2 a0 a1 i
    t0 = (a[0] + a[1]) * (a[0] - a[1])
    t1 = 2 * a[0] * a[1]
    return (t0 % P, t1 % P)


def fq2_scalar_mul(a, k: int):
    return ((a[0] * k) % P, (a[1] * k) % P)


def fq2_conj(a):
    return (a[0], (-a[1]) % P)


def fq2_inv(a):
    # 1/(a0 + a1 i) = (a0 - a1 i) / (a0^2 + a1^2)
    norm = (a[0] * a[0] + a[1] * a[1]) % P
    inv = fq_inv(norm)
    return ((a[0] * inv) % P, (-a[1] * inv) % P)


def fq2_mul_xi(a):
    """Multiply by xi = 9 + i."""
    return ((9 * a[0] - a[1]) % P, (a[0] + 9 * a[1]) % P)


def fq2_pow(a, e: int):
    result = FQ2_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq2_mul(result, base)
        base = fq2_sq(base)
        e >>= 1
    return result


def fq2_is_zero(a) -> bool:
    return a[0] % P == 0 and a[1] % P == 0


def fq2_sqrt(a):
    """Square root in Fq2, or None if a is not a QR.

    Uses the complex method: for a = a0 + a1*i with i^2 = -1,
    norm(a) = a0^2 + a1^2 must be a QR in Fq; then
    x0 = sqrt((a0 + sqrt(norm))/2) (or the other sign), x1 = a1/(2 x0).
    """
    if fq2_is_zero(a):
        return FQ2_ZERO
    a0, a1 = a[0] % P, a[1] % P
    if a1 == 0:
        s = fq_sqrt(a0)
        if s is not None:
            return (s, 0)
        # a0 is a non-residue: sqrt = t*i with -t^2 = a0
        s = fq_sqrt((-a0) % P)
        if s is None:
            return None
        return (0, s)
    alpha = fq_sqrt((a0 * a0 + a1 * a1) % P)
    if alpha is None:
        return None
    delta = ((a0 + alpha) * fq_inv(2)) % P
    x0 = fq_sqrt(delta)
    if x0 is None:
        delta = ((a0 - alpha) * fq_inv(2)) % P
        x0 = fq_sqrt(delta)
        if x0 is None:
            return None
    x1 = (a1 * fq_inv(2 * x0)) % P
    res = (x0, x1)
    assert fq2_sub(fq2_sq(res), (a0, a1)) == FQ2_ZERO
    return res


# ---------------------------------------------------------------------------
# Fq6 = Fq2[v] / (v^3 - xi)
# ---------------------------------------------------------------------------

FQ6_ZERO = (FQ2_ZERO, FQ2_ZERO, FQ2_ZERO)
FQ6_ONE = (FQ2_ONE, FQ2_ZERO, FQ2_ZERO)


def fq6_add(a, b):
    return (fq2_add(a[0], b[0]), fq2_add(a[1], b[1]), fq2_add(a[2], b[2]))


def fq6_sub(a, b):
    return (fq2_sub(a[0], b[0]), fq2_sub(a[1], b[1]), fq2_sub(a[2], b[2]))


def fq6_neg(a):
    return (fq2_neg(a[0]), fq2_neg(a[1]), fq2_neg(a[2]))


def fq6_mul(a, b):
    # Schoolbook with reduction v^3 = xi
    a0, a1, a2 = a
    b0, b1, b2 = b
    t0 = fq2_mul(a0, b0)
    t1 = fq2_mul(a1, b1)
    t2 = fq2_mul(a2, b2)
    # c0 = t0 + xi*((a1+a2)(b1+b2) - t1 - t2)
    c0 = fq2_add(
        t0,
        fq2_mul_xi(
            fq2_sub(fq2_sub(fq2_mul(fq2_add(a1, a2), fq2_add(b1, b2)), t1), t2)
        ),
    )
    # c1 = (a0+a1)(b0+b1) - t0 - t1 + xi*t2
    c1 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a1), fq2_add(b0, b1)), t0), t1),
        fq2_mul_xi(t2),
    )
    # c2 = (a0+a2)(b0+b2) - t0 - t2 + t1
    c2 = fq2_add(
        fq2_sub(fq2_sub(fq2_mul(fq2_add(a0, a2), fq2_add(b0, b2)), t0), t2), t1
    )
    return (c0, c1, c2)


def fq6_sq(a):
    return fq6_mul(a, a)


def fq6_mul_by_v(a):
    """Multiply by v: (a0 + a1 v + a2 v^2) * v = xi*a2 + a0 v + a1 v^2."""
    return (fq2_mul_xi(a[2]), a[0], a[1])


def fq6_inv(a):
    a0, a1, a2 = a
    c0 = fq2_sub(fq2_sq(a0), fq2_mul_xi(fq2_mul(a1, a2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sq(a2)), fq2_mul(a0, a1))
    c2 = fq2_sub(fq2_sq(a1), fq2_mul(a0, a2))
    t = fq2_add(
        fq2_add(fq2_mul_xi(fq2_mul(a2, c1)), fq2_mul_xi(fq2_mul(a1, c2))),
        fq2_mul(a0, c0),
    )
    t_inv = fq2_inv(t)
    return (fq2_mul(c0, t_inv), fq2_mul(c1, t_inv), fq2_mul(c2, t_inv))


def fq6_is_zero(a) -> bool:
    return all(fq2_is_zero(c) for c in a)


# ---------------------------------------------------------------------------
# Fq12 = Fq6[w] / (w^2 - v)
# ---------------------------------------------------------------------------

FQ12_ZERO = (FQ6_ZERO, FQ6_ZERO)
FQ12_ONE = (FQ6_ONE, FQ6_ZERO)


def fq12_add(a, b):
    return (fq6_add(a[0], b[0]), fq6_add(a[1], b[1]))


def fq12_sub(a, b):
    return (fq6_sub(a[0], b[0]), fq6_sub(a[1], b[1]))


def fq12_neg(a):
    return (fq6_neg(a[0]), fq6_neg(a[1]))


def fq12_mul(a, b):
    # (a0 + a1 w)(b0 + b1 w) = (a0b0 + v a1b1) + (a0b1 + a1b0) w
    t0 = fq6_mul(a[0], b[0])
    t1 = fq6_mul(a[1], b[1])
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(
        fq6_sub(fq6_mul(fq6_add(a[0], a[1]), fq6_add(b[0], b[1])), t0), t1
    )
    return (c0, c1)


def fq12_sq(a):
    return fq12_mul(a, a)


def fq12_conj(a):
    """Conjugate w -> -w; this is the p^6 Frobenius."""
    return (a[0], fq6_neg(a[1]))


def fq12_inv(a):
    # 1/(a0 + a1 w) = (a0 - a1 w)/(a0^2 - v a1^2)
    t = fq6_sub(fq6_sq(a[0]), fq6_mul_by_v(fq6_sq(a[1])))
    t_inv = fq6_inv(t)
    return (fq6_mul(a[0], t_inv), fq6_neg(fq6_mul(a[1], t_inv)))


def fq12_pow(a, e: int):
    if e < 0:
        return fq12_pow(fq12_inv(a), -e)
    result = FQ12_ONE
    base = a
    while e > 0:
        if e & 1:
            result = fq12_mul(result, base)
        base = fq12_sq(base)
        e >>= 1
    return result


def fq12_eq(a, b) -> bool:
    return fq12_sub(a, b) == FQ12_ZERO or _canon12(a) == _canon12(b)


def _canon12(a):
    return tuple(
        tuple(tuple(c % P for c in c2) for c2 in c6) for c6 in a
    )


# ---------------------------------------------------------------------------
# Frobenius endomorphism coefficients (computed once at import with ints).
#
# frob^k on Fq12 in this tower acts on the Fq2 coefficients c_{i,j} of
# a = sum_{i<3, j<2} c_{i,j} v^i w^j as:
#   c -> conj^k(c) * gamma_{i,j,k}
# where gamma are powers of xi. We store coefficients for k = 1, 2, 3.
# ---------------------------------------------------------------------------


# v^(p^k) = xi^((p^k - 1)/3) * v ;  w^(p^k) = xi^((p^k - 1)/6) * w
FROB_GAMMA_V = {k: fq2_pow(XI, (P**k - 1) // 3) for k in (1, 2, 3)}
FROB_GAMMA_V2 = {k: fq2_pow(XI, 2 * (P**k - 1) // 3) for k in (1, 2, 3)}
FROB_GAMMA_W = {k: fq2_pow(XI, (P**k - 1) // 6) for k in (1, 2, 3)}


def fq2_frob(a, k: int):
    """a^(p^k) on Fq2: identity for even k, conjugation for odd k."""
    return a if k % 2 == 0 else fq2_conj(a)


def fq6_frob(a, k: int):
    return (
        fq2_frob(a[0], k),
        fq2_mul(fq2_frob(a[1], k), FROB_GAMMA_V[k]),
        fq2_mul(fq2_frob(a[2], k), FROB_GAMMA_V2[k]),
    )


def fq12_frob(a, k: int):
    """a^(p^k) on Fq12 for k in {1, 2, 3}."""
    gw = FROB_GAMMA_W[k]
    c0 = fq6_frob(a[0], k)
    c1 = fq6_frob(a[1], k)
    # multiply every Fq2 coefficient of the w-part by gamma_w
    c1 = tuple(fq2_mul(c, gw) for c in c1)
    return (c0, c1)
