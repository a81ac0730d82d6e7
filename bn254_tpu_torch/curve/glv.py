"""GLV endomorphism Shamir ladder for RLC batch-verification weights.

Counterpart of `bn254_tpu/curve/glv.py`, with its unrolled form (one fused
kernel launch per ladder step, on CUDA tensors under
`config.unroll_static_loops`) and its scan form (otherwise, leaf by leaf).
Weights are drawn directly in GLV form w = a + λ·b (mod r) with a, b
uniform (bits//2)-bit, where λ is the eigenvalue of φ(x, y) = (β·x, y) on
G1. Then

    [w]P = [a]P + [b]φ(P)

by ONE (bits//2)-step Shamir ladder over the table {O, P, φP, P + φP}:
per step one Jacobian doubling plus one complete addition of a
mask-selected table entry — half the steps of the generic ladder at the
same soundness. (a, b) -> a + λb mod r is injective on [0, 2^126)^2 (the
shortest vector of the lattice {(x, y): x + λy ≡ 0 mod r} has norm
≈ 2^127), so w is uniform over a set of size 2^bits.

RLC weights are cryptographic: `random_glv_weights` draws them with
`secrets`. A seeded generator would make them predictable and void the
2^-bits forgery bound.
"""

from __future__ import annotations

import dataclasses
import secrets

from ..constants import LIMB_BITS, P, R
from ..fields import limbs as L
from ..fields import tower as T
from . import jacobian as J
from .ops import FqOps

BETA = 0x59E26BCEA0D48BACD4F263F1ACDB5C4F5763473177FFFFFE
LAMBDA = 0xB3C4D79D41A917585BFC41088D8DAAA78B17EA66B99C90DD

assert (BETA * BETA + BETA + 1) % P == 0
assert (LAMBDA * LAMBDA + LAMBDA + 1) % R == 0


@dataclasses.dataclass(frozen=True)
class GlvWeights:
    """RLC weights in GLV form: w_i = a_i + λ·b_i (mod r).

    a, b: (18, B) canonical limb tensors, each value < 2^(bits//2).
    bits: total soundness width — the ladder runs bits//2 steps.
    """

    a: L.El
    b: L.El
    bits: int

    @property
    def half_bits(self) -> int:
        return self.bits // 2

    def to(self, device) -> "GlvWeights":
        mv = lambda e: L.El(e.arr.to(device), e.vmax, e.lmax)
        return GlvWeights(mv(self.a), mv(self.b), self.bits)


def random_glv_weights(n: int, bits: int | None = None,
                       device="cpu") -> GlvWeights:
    """Draw n RLC weights in GLV form (first fixed to w_0 = 1 = (1, 0)).

    bits: total soundness width (default config.rlc_bits; even, with
    bits//2 <= 126 so the injectivity argument holds). The zero pair is
    redrawn, so the weight set has 2^bits - 1 elements.
    """
    if bits is None:
        from .. import config as C

        bits = C.DEFAULT.rlc_bits
    if bits % 2 != 0 or bits < 2:
        raise ValueError(
            f"rlc_bits must be even and >= 2 for GLV weights, got {bits}"
        )
    half = bits // 2
    if half > 126:
        raise ValueError(
            f"rlc_bits {bits} too wide: the GLV injectivity bound "
            "(shortest lattice vector ~2^127) only guarantees a "
            "collision-free weight set for bits//2 <= 126"
        )

    def draw():
        while True:
            a, b = secrets.randbits(half), secrets.randbits(half)
            if a or b:
                return a, b

    pairs = [(1, 0)] + [draw() for _ in range(n - 1)]
    return glv_weights_to_device(pairs, bits, device)


def glv_weights_to_device(pairs, bits: int, device="cpu") -> GlvWeights:
    """Host (a, b) int pairs -> validated device GlvWeights (vmax pinned to
    the validated bound 2^(bits//2), as in the JAX package)."""
    half = bits // 2
    for a, b in pairs:
        if (int(a) >> half) or (int(b) >> half):
            raise ValueError(
                f"GLV weight half ({int(a):#x}, {int(b):#x}) exceeds "
                f"{half} bits; the {half}-step Shamir ladder would "
                "truncate it"
            )
    return GlvWeights(
        L.from_ints([int(a) for a, _ in pairs], vmax=1 << half, device=device),
        L.from_ints([int(b) for _, b in pairs], vmax=1 << half, device=device),
        bits,
    )


def weight_values(w: GlvWeights):
    """Host ints w_i = a_i + λ b_i mod r (for oracle cross-checks)."""
    a = L.to_ints(w.a)
    b = L.to_ints(w.b)
    return [(int(x) + LAMBDA * int(y)) % R for x, y in zip(a.ravel(), b.ravel())]


def phi(p: J.JPoint) -> J.JPoint:
    """The GLV endomorphism on Jacobian coords: (X, Y, Z) -> (βX, Y, Z)."""
    beta = T.mont_const(BETA, p.x.device)
    return J.JPoint(L.mont_mul(p.x, beta), p.y, p.z)


# ---------------------------------------------------------------------------
# Shamir ladder (MSB-first, fixed schedule, branch-free)
# ---------------------------------------------------------------------------


def _pin(e: L.El) -> L.El:
    """Pin (vmax, lmax) to the (STD_BOUND, 2^16) fixed point (the same
    stabilisation the Miller loop uses — see miller._pin_el)."""
    if e.vmax > L.STD_BOUND:
        e = L.vreduce(e)
    if e.lmax > (1 << 16):
        e = L.norm_limbs(e)
    return L.retag(e, L.STD_BOUND, 1 << 16)


def _pin_point(p: J.JPoint) -> J.JPoint:
    return J.JPoint(_pin(p.x), _pin(p.y), _pin(p.z))


def _select_point(mask, t: J.JPoint, f: J.JPoint) -> J.JPoint:
    return J.JPoint(
        L.select(mask, t.x, f.x),
        L.select(mask, t.y, f.y),
        L.select(mask, t.z, f.z),
    )


def _table(p: J.JPoint):
    """{O, P, φP, P+φP} with every entry bound-pinned."""
    p1 = _pin_point(p)
    p2 = _pin_point(phi(p1))
    p3 = _pin_point(J.add(FqOps, p1, p2))
    ident = _pin_point(J.identity(FqOps, p.x.batch_shape, p.x.device))
    return ident, p1, p2, p3


def _select_entry(bit_a, bit_b, table):
    """table[2*bit_b + bit_a] via 3 masked point selects."""
    ident, p1, p2, p3 = table
    lo = _select_point(bit_b, p2, ident)  # a=0 half
    hi = _select_point(bit_b, p3, p1)  # a=1 half
    return _select_point(bit_a, hi, lo)


def _bit(arr, i: int):
    """Bit i of a (18, *batch) canonical limb tensor, as a batch bool."""
    return ((arr[i // LIMB_BITS] >> (i % LIMB_BITS)) & 1) != 0


def _dbl_add_body_impl(ax: L.El, ay: L.El, az: L.El, sx: L.El, sy: L.El,
                       sz: L.El):
    """2*acc + sel (kernel "glv_dbl_add"): Jacobian doubling + COMPLETE
    masked addition, which handles identity operands and acc == ±sel."""
    acc = J.double(FqOps, J.JPoint(ax, ay, az))
    out = J.add(FqOps, acc, J.JPoint(sx, sy, sz))
    return _pin(out.x), _pin(out.y), _pin(out.z)


def shamir_scalar_mul(p: J.JPoint, w: GlvWeights) -> J.JPoint:
    """[a]P + [b]φ(P) by a (bits//2)-step MSB-first Shamir ladder.

    The 2-bit table index is data (a masked select per step), the schedule
    is static. On CUDA tensors under `config.unroll_static_loops` each step
    is one "glv_dbl_add" kernel launch (`_shamir_unrolled`); otherwise the
    JAX package's scan form as a Python loop (`_shamir_scan`).
    """
    from .. import config as C

    table = _table(p)
    if C.DEFAULT.unroll_static_loops and T._use_kernels(p.x, w.a):
        return _shamir_unrolled(table, w, w.half_bits)
    return _shamir_scan(table, w, w.half_bits)


def _shamir_unrolled(table, w: GlvWeights, nbits: int) -> J.JPoint:
    from ..kernels import fused as FK

    acc = table[0]
    for i in range(nbits - 1, -1, -1):
        sel = _select_entry(_bit(w.a.arr, i), _bit(w.b.arr, i), table)
        acc = J.JPoint(*FK.fused_op(_dbl_add_body_impl, "glv_dbl_add",
                                    *acc, *sel))
    return acc


def _shamir_scan(table, w: GlvWeights, nbits: int) -> J.JPoint:
    acc = table[0]
    for i in range(nbits - 1, -1, -1):
        sel = _select_entry(_bit(w.a.arr, i), _bit(w.b.arr, i), table)
        acc = J.double(FqOps, acc)
        acc = _pin_point(J.add(FqOps, acc, sel))
    return acc
