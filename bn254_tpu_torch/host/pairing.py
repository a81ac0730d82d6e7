"""Host-side (pure Python int) optimal-ate pairing oracle for BN254.

Deliberately simple: G2 points are mapped through the sextic twist into
E(Fq12) and the Miller loop runs with affine arithmetic and exact divisions.
The final exponentiation is a generic pow by (p^12 - 1)/r, which is the
canonical pairing exponent — so results are comparable bit-for-bit with any
correct optimal-ate implementation (including the device pipeline and the
reference's `pairing_batch`, reference src/ecdsa.rs:57).

This is the oracle/verification path. As in its twin in the JAX package,
`pairing` and `pairing_batch` (which `protocol/ecdsa.py` runs) dispatch to
the native C++ host core (`native.py`) when it is available;
`pairing_batch_py` is the pure-Python oracle. The device implementation in
`pairing/` uses twisted-coordinate line evaluation and a structured final
exponentiation instead.
"""

from __future__ import annotations

from ..constants import ATE_LOOP_COUNT, P, R
from . import field as F
from .curve import g1_to_affine, g2_to_affine

# Canonical final-exponentiation exponent
FINAL_EXP = (P**12 - 1) // R


def _embed_fq(x: int):
    """Fq -> Fq12 scalar embedding."""
    return (((x % P, 0), F.FQ2_ZERO, F.FQ2_ZERO), F.FQ6_ZERO)


def twist(q_affine):
    """Map an affine point of E'(Fq2) to E(Fq12) via the D-twist.

    With the tower w^2 = v, v^3 = xi (so w^6 = xi), the map is
    (x', y') -> (x' * w^2, y' * w^3).
    """
    if q_affine is None:
        return None
    x2, y2 = q_affine
    x12 = ((F.FQ2_ZERO, x2, F.FQ2_ZERO), F.FQ6_ZERO)  # x' * v
    y12 = (F.FQ6_ZERO, (F.FQ2_ZERO, y2, F.FQ2_ZERO))  # y' * v * w
    return (x12, y12)


def _fq12_div(a, b):
    return F.fq12_mul(a, F.fq12_inv(b))


def miller_loop(q_affine_fq12, p_affine) -> tuple:
    """Miller loop f_{6u+2, Q}(P) with the two Frobenius addition steps.

    `q_affine_fq12`: affine point on E(Fq12) (output of `twist`).
    `p_affine`: affine G1 point (ints).
    Returns an Fq12 value (pre-final-exponentiation).
    """
    if q_affine_fq12 is None or p_affine is None:
        return F.FQ12_ONE
    xp = _embed_fq(p_affine[0])
    yp = _embed_fq(p_affine[1])

    fq12 = F

    def dbl_step(rx, ry):
        # slope m = 3 x^2 / 2y ; line l = m (xp - x) - (yp - y)
        m = _fq12_div(
            fq12.fq12_mul(_embed_fq(3), fq12.fq12_sq(rx)),
            fq12.fq12_mul(_embed_fq(2), ry),
        )
        line = fq12.fq12_sub(
            fq12.fq12_mul(m, fq12.fq12_sub(xp, rx)), fq12.fq12_sub(yp, ry)
        )
        x3 = fq12.fq12_sub(fq12.fq12_sq(m), fq12.fq12_mul(_embed_fq(2), rx))
        y3 = fq12.fq12_sub(fq12.fq12_mul(m, fq12.fq12_sub(rx, x3)), ry)
        return (x3, y3), line

    def add_step(rx, ry, qx, qy):
        # slope m = (qy - ry) / (qx - rx)
        m = _fq12_div(fq12.fq12_sub(qy, ry), fq12.fq12_sub(qx, rx))
        line = fq12.fq12_sub(
            fq12.fq12_mul(m, fq12.fq12_sub(xp, rx)), fq12.fq12_sub(yp, ry)
        )
        x3 = fq12.fq12_sub(fq12.fq12_sub(fq12.fq12_sq(m), rx), qx)
        y3 = fq12.fq12_sub(fq12.fq12_mul(m, fq12.fq12_sub(rx, x3)), ry)
        return (x3, y3), line

    qx, qy = q_affine_fq12
    rx, ry = qx, qy
    f = F.FQ12_ONE
    bits = bin(ATE_LOOP_COUNT)[2:]
    for bit in bits[1:]:
        f = fq12.fq12_sq(f)
        (rx, ry), line = dbl_step(rx, ry)
        f = fq12.fq12_mul(f, line)
        if bit == "1":
            (rx, ry), line = add_step(rx, ry, qx, qy)
            f = fq12.fq12_mul(f, line)

    # Frobenius addition steps: Q1 = pi_p(Q), Q2 = pi_p^2(Q); add Q1 then -Q2.
    q1 = (fq12.fq12_frob(qx, 1), fq12.fq12_frob(qy, 1))
    nq2 = (fq12.fq12_frob(qx, 2), fq12.fq12_neg(fq12.fq12_frob(qy, 2)))
    (rx, ry), line = add_step(rx, ry, q1[0], q1[1])
    f = fq12.fq12_mul(f, line)
    (rx, ry), line = add_step(rx, ry, nq2[0], nq2[1])
    f = fq12.fq12_mul(f, line)
    return f


def final_exponentiation(f):
    return F.fq12_pow(f, FINAL_EXP)


def structured_final_exp(f):
    """Easy part (p^6-1)(p^2+1) then the Devegili-style hard-part chain.

    Verified equal to the generic pow by tests (the final-exp exponent is
    canonical, so any correct algorithm agrees bit-for-bit). This is the
    structure the device pipeline uses; kept on the host as the faster
    host path and as the porting reference.
    """
    from ..constants import U

    def exp_u(x):
        return F.fq12_pow(x, U)

    # easy part
    f = F.fq12_mul(F.fq12_conj(f), F.fq12_inv(f))  # f^(p^6 - 1)
    f = F.fq12_mul(F.fq12_frob(f, 2), f)  # ^(p^2 + 1)

    # hard part (p^4 - p^2 + 1)/r
    ft1 = exp_u(f)
    ft2 = exp_u(ft1)
    ft3 = exp_u(ft2)
    fp1 = F.fq12_frob(f, 1)
    fp2 = F.fq12_frob(f, 2)
    fp3 = F.fq12_frob(f, 3)
    y0 = F.fq12_mul(F.fq12_mul(fp1, fp2), fp3)
    y1 = F.fq12_conj(f)
    y2 = F.fq12_frob(ft2, 2)
    y3 = F.fq12_conj(F.fq12_frob(ft1, 1))
    y4 = F.fq12_conj(F.fq12_mul(ft1, F.fq12_frob(ft2, 1)))
    y5 = F.fq12_conj(ft2)
    y6 = F.fq12_conj(F.fq12_mul(ft3, F.fq12_frob(ft3, 1)))
    t0 = F.fq12_mul(F.fq12_mul(F.fq12_sq(y6), y4), y5)
    t1 = F.fq12_mul(F.fq12_mul(y3, y5), t0)
    t0 = F.fq12_mul(t0, y2)
    t1 = F.fq12_sq(F.fq12_mul(F.fq12_sq(t1), t0))
    return F.fq12_mul(F.fq12_mul(t1, y0), F.fq12_sq(F.fq12_mul(t1, y1)))


def _native() -> bool:
    from . import native as N

    return N.available()


def pairing(g1_jac, g2_jac):
    """Full pairing e(P, Q) for Jacobian G1/G2 inputs."""
    p_aff = g1_to_affine(g1_jac)
    q_aff = g2_to_affine(g2_jac)
    if _native():
        from . import native as N

        return N.pairing(p_aff, q_aff)
    return final_exponentiation(miller_loop(twist(q_aff), p_aff))


def pairing_batch(pairs) -> tuple:
    """Product of pairings with a single shared final exponentiation.

    Mirrors the reference's `pairing_batch(&[(G1, G2)]) -> Gt`
    (reference src/ecdsa.rs:57,86): multiply the per-pair Miller-loop
    values in Fq12, then run final exponentiation once. Dispatches to the
    native core when it is available; `pairing_batch_py` is the oracle.
    """
    if _native():
        from . import native as N

        return N.pairing_product(
            [(g1_to_affine(p), g2_to_affine(q)) for p, q in pairs])
    return pairing_batch_py(pairs)


def pairing_batch_py(pairs) -> tuple:
    """Pure-Python pairing product (oracle path, native never consulted)."""
    acc = F.FQ12_ONE
    for g1_jac, g2_jac in pairs:
        p_aff = g1_to_affine(g1_jac)
        q_aff = g2_to_affine(g2_jac)
        acc = F.fq12_mul(acc, miller_loop(twist(q_aff), p_aff))
    return final_exponentiation(acc)


GT_ONE = F.FQ12_ONE


def gt_eq(a, b) -> bool:
    return F.fq12_eq(a, b)
