"""Plain BN254 BLS arithmetic on Python ints: the benchmark's reference.

It imports nothing of the program under test and takes nothing the program
made. It makes the benchmark's tuples from a seed and works out each
tuple's verdict by the BLS relation, knowing the secret keys: a tuple
(m, sig, pk = [sk]G2) is valid exactly when sig == [sk]H(m), since
e(H(m), [sk]G2) == e([sk]H(m), G2) and the pairing is non-degenerate on
the prime-order groups (G1 has cofactor 1). It also works out a weighted
sum of G1 points (`g1_glv_sum`), which a run holds the program's fused
check's signature sum against.

Curve: alt_bn128 (EIP-196/197). G1: y^2 = x^3 + 3 over Fq. G2 on the twist
y^2 = x^3 + 3/(9 + i) over Fq2 = Fq[i]/(i^2 + 1). H is SHA-256
try-and-increment: for ctr = 0, 1, ...: a = BE(SHA256(m || ctr)); skip
a >= 5p; reduce by subtracting p while a > p (a == p is skipped); take the
point with x = a whose y is even, if x^3 + 3 is a square.
"""

from __future__ import annotations

import hashlib

P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617
G2_GEN = (
    (0x1800DEEF121F1E76426A00665E5C4479674322D4F75EDADD46DEBD5CD992F6ED,
     0x198E9393920D483A7260BFB731FB5D25F1AA493335A9E71297E485B7AEF312C2),
    (0x12C85EA5DB8C6DEB4AAB71808DCB408FE3D1E7690C43D37B4CE6CC0166FA7DAA,
     0x090689D0585FF075EC9E99AD690C3395BC4B313370B38EF355ACDADCD122975B),
)
_SQRT_EXP = (P + 1) // 4  # p = 3 mod 4
# the GLV eigenvalue: a root of x^2 + x + 1 mod R, the scalar by which the
# endomorphism (x, y) -> (beta x, y) multiplies G1, with beta =
# 0x59E26BCEA0D48BACD4F263F1ACDB5C4F5763473177FFFFFE (a cube root of 1 mod P)
GLV_LAMBDA = 0xB3C4D79D41A917585BFC41088D8DAAA78B17EA66B99C90DD


def hash_to_g1(message: bytes) -> tuple[int, int]:
    """H(m) as an affine point (x, y), y even."""
    v = bytearray(message + b"\x00")
    for ctr in range(255):
        v[-1] = ctr
        a = int.from_bytes(hashlib.sha256(v).digest(), "big")
        if a >= 5 * P:
            continue
        while a > P:
            a -= P
        if a == P:
            continue
        y2 = (a * a * a + 3) % P
        y = pow(y2, _SQRT_EXP, P)
        if y * y % P != y2:
            continue
        return a, (P - y if y & 1 else y)
    raise ValueError("no point in 255 counters")


# -- G1, Jacobian (X, Y, Z) over Fq, affine base in the ladder ------------


def _g1_dbl(X, Y, Z):
    a = X * X % P
    b = Y * Y % P
    c = b * b % P
    d = 2 * ((X + b) * (X + b) - a - c) % P
    e = 3 * a % P
    x3 = (e * e - 2 * d) % P
    return x3, (e * (d - x3) - 8 * c) % P, 2 * Y * Z % P


def _g1_madd(X, Y, Z, x, y):
    """(X, Y, Z) + (x, y, 1); the ladder never adds a point to itself or
    to its negative (the running multiple is below the group order)."""
    zz = Z * Z % P
    u2 = x * zz % P
    s2 = y * Z * zz % P
    h = (u2 - X) % P
    hh = h * h % P
    i = 4 * hh % P
    j = h * i % P
    r = 2 * (s2 - Y) % P
    v = X * i % P
    x3 = (r * r - j - 2 * v) % P
    y3 = (r * (v - x3) - 2 * Y * j) % P
    z3 = ((Z + h) * (Z + h) - zz - hh) % P
    return x3, y3, z3


def g1_mul(point: tuple[int, int], k: int) -> tuple[int, int]:
    """[k]point, affine, for 0 < k < R and a point of G1."""
    x, y = point
    X, Y, Z = x, y, 1
    for bit in bin(k)[3:]:
        X, Y, Z = _g1_dbl(X, Y, Z)
        if bit == "1":
            X, Y, Z = _g1_madd(X, Y, Z, x, y)
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def _g1_add(p, q):
    """Jacobian p + q for any two points (None: the identity)."""
    if p is None:
        return q
    if q is None:
        return p
    X1, Y1, Z1 = p
    X2, Y2, Z2 = q
    z1z1, z2z2 = Z1 * Z1 % P, Z2 * Z2 % P
    u1, u2 = X1 * z2z2 % P, X2 * z1z1 % P
    s1, s2 = Y1 * Z2 * z2z2 % P, Y2 * Z1 * z1z1 % P
    if u1 == u2:
        return _g1_dbl(X1, Y1, Z1) if s1 == s2 else None
    h = u2 - u1
    r = s2 - s1
    hh = h * h % P
    hhh = h * hh % P
    v = u1 * hh % P
    x3 = (r * r - hhh - 2 * v) % P
    return x3, (r * (v - x3) - s1 * hhh) % P, Z1 * Z2 * h % P


def _g1_affine(p):
    if p is None:
        return None
    X, Y, Z = p
    zi = pow(Z, -1, P)
    zi2 = zi * zi % P
    return X * zi2 % P, Y * zi2 * zi % P


def g1_msm(scalars, points, window: int = 10):
    """sum_i [k_i] points_i, affine (None: the identity), for k_i >= 0
    and points of G1: Pippenger's buckets, `window` bits at a time."""
    top = max(scalars, default=0).bit_length()
    acc = None
    mask = (1 << window) - 1
    for shift in reversed(range(0, max(top, 1), window)):
        for _ in range(window if acc is not None else 0):
            acc = None if acc is None else _g1_dbl(*acc)
        buckets = [None] * (mask + 1)
        for k, (x, y) in zip(scalars, points):
            d = (k >> shift) & mask
            if d:
                buckets[d] = _g1_add(buckets[d], (x, y, 1))
        run = total = None
        for b in reversed(buckets[1:]):
            run = _g1_add(run, b)
            total = _g1_add(total, run)
        acc = _g1_add(acc, total)
    return _g1_affine(acc)


def g1_glv_sum(a, b, points):
    """sum_i [a_i + GLV_LAMBDA b_i] points_i, affine (None: the identity):
    a batch's signature sum under RLC weights in GLV form."""
    sa = g1_msm(a, points)
    sb = g1_msm(b, points)
    lb = None if sb is None else (*g1_mul(sb, GLV_LAMBDA), 1)
    return _g1_affine(_g1_add(None if sa is None else (*sa, 1), lb))


# -- G2, Jacobian over Fq2 (pairs (c0, c1) = c0 + c1 i) -------------------


def _f2_mul(a, b):
    return ((a[0] * b[0] - a[1] * b[1]) % P, (a[0] * b[1] + a[1] * b[0]) % P)


def _f2_add(a, b):
    return ((a[0] + b[0]) % P, (a[1] + b[1]) % P)


def _f2_sub(a, b):
    return ((a[0] - b[0]) % P, (a[1] - b[1]) % P)


def _f2_small(a, k):
    return (a[0] * k % P, a[1] * k % P)


def _f2_inv(a):
    t = pow((a[0] * a[0] + a[1] * a[1]) % P, -1, P)
    return (a[0] * t % P, -a[1] * t % P)


def _g2_dbl(X, Y, Z):
    a = _f2_mul(X, X)
    b = _f2_mul(Y, Y)
    c = _f2_mul(b, b)
    xb = _f2_add(X, b)
    d = _f2_small(_f2_sub(_f2_sub(_f2_mul(xb, xb), a), c), 2)
    e = _f2_small(a, 3)
    x3 = _f2_sub(_f2_mul(e, e), _f2_small(d, 2))
    y3 = _f2_sub(_f2_mul(e, _f2_sub(d, x3)), _f2_small(c, 8))
    return x3, y3, _f2_small(_f2_mul(Y, Z), 2)


def _g2_madd(X, Y, Z, x, y):
    zz = _f2_mul(Z, Z)
    u2 = _f2_mul(x, zz)
    s2 = _f2_mul(y, _f2_mul(Z, zz))
    h = _f2_sub(u2, X)
    hh = _f2_mul(h, h)
    i = _f2_small(hh, 4)
    j = _f2_mul(h, i)
    r = _f2_small(_f2_sub(s2, Y), 2)
    v = _f2_mul(X, i)
    x3 = _f2_sub(_f2_sub(_f2_mul(r, r), j), _f2_small(v, 2))
    y3 = _f2_sub(_f2_mul(r, _f2_sub(v, x3)), _f2_small(_f2_mul(Y, j), 2))
    zh = _f2_add(Z, h)
    z3 = _f2_sub(_f2_sub(_f2_mul(zh, zh), zz), hh)
    return x3, y3, z3


def g2_mul(point, k: int):
    """[k]point, affine ((x0, x1), (y0, y1)), for 0 < k < R on G2."""
    x, y = point
    X, Y, Z = x, y, (1, 0)
    for bit in bin(k)[3:]:
        X, Y, Z = _g2_dbl(X, Y, Z)
        if bit == "1":
            X, Y, Z = _g2_madd(X, Y, Z, x, y)
    zi = _f2_inv(Z)
    zi2 = _f2_mul(zi, zi)
    return _f2_mul(X, zi2), _f2_mul(Y, _f2_mul(zi2, zi))


def public_key(sk: int):
    """pk = [sk]G2, affine."""
    return g2_mul(G2_GEN, sk)


def sign(message: bytes, sk: int) -> tuple[int, int]:
    """sig = [sk]H(m), affine."""
    return g1_mul(hash_to_g1(message), sk)


def valid(message: bytes, sig, sk: int) -> bool:
    """The BLS verdict of (message, sig, [sk]G2)."""
    return tuple(sig) == sign(message, sk)
