"""Tower fields Fq2 / Fq6 / Fq12 over the lazy limb engine.

Counterpart of `bn254_tpu/fields/tower.py`. On CUDA tensors `fq12_mul`,
`fq12_sq` and `fq12_cyc_sq` each run as one fused kernel launch
(kernels/fused.py), as the JAX package's run as one Pallas kernel; their
`_impl` bodies, and everything else here, are the plain formula graph the
JAX package runs on the CPU. Every tower
multiplication gathers its leaf Fq multiplications into ONE batched
`mont_mul` call by stacking operands along an internal batch axis (axis 1,
after the limb axis):

    Fq2  mul -> 3 leaves   (Karatsuba)
    Fq6  mul -> 6 Fq2 muls -> 18 leaves
    Fq12 mul -> 3 Fq6 muls -> 54 leaves, one mont_mul (one kernel launch)

Tower (matching the host oracle / alt_bn128 convention):
    Fq2  = Fq[i]/(i^2+1),  Fq6 = Fq2[v]/(v^3 - xi),  Fq12 = Fq6[w]/(w^2 - v)
with xi = 9 + i. All elements are Montgomery-domain `limbs.El`s; constants
are built on the device of the operand they meet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from ..constants import MONT_R_MOD_P, P
from ..host import field as HF
from ..kernels import fused as FK
from . import limbs as L

El = L.El


class Fq2(NamedTuple):
    c0: El
    c1: El


class Fq6(NamedTuple):
    c0: Fq2
    c1: Fq2
    c2: Fq2


class Fq12(NamedTuple):
    c0: Fq6
    c1: Fq6


def _use_kernels(*els: El) -> bool:
    """Whether an op runs as a fused CUDA kernel (kernels/fused.py): the
    Fq12 ops here, `limbs.pow_fixed`, the GLV ladder, and the unrolled
    Miller loop and exp_u with their bodies. True on CUDA tensors, except
    inside a fused body run as plain code. The counterpart of the JAX
    package's `_use_fused`; not a config knob (tests force `_on_card` on
    the CPU, where `fused_op` then calls the plain bodies)."""
    return not L._KERNEL_MODE and _on_card(els)


def _on_card(els) -> bool:
    return any(e.arr.is_cuda for e in els)


# ---------------------------------------------------------------------------
# stacking helpers (gather independent ops into one batched call)
# ---------------------------------------------------------------------------


def fq2_stack(elems):
    return Fq2(
        L.stack([e.c0 for e in elems]), L.stack([e.c1 for e in elems])
    )


def fq2_unstack(e: Fq2, n: int):
    return [Fq2(a, b) for a, b in zip(L.unstack(e.c0, n), L.unstack(e.c1, n))]


def fq6_stack(elems):
    return Fq6(
        fq2_stack([e.c0 for e in elems]),
        fq2_stack([e.c1 for e in elems]),
        fq2_stack([e.c2 for e in elems]),
    )


def fq6_unstack(e: Fq6, n: int):
    return [
        Fq6(a, b, c)
        for a, b, c in zip(
            fq2_unstack(e.c0, n), fq2_unstack(e.c1, n), fq2_unstack(e.c2, n)
        )
    ]


# ---------------------------------------------------------------------------
# constants
# ---------------------------------------------------------------------------


def mont_const(x: int, device="cpu") -> El:
    """Host int -> (18,) Montgomery-form constant El."""
    return L.const_el((x * MONT_R_MOD_P) % P, device)


def const_fq2(value: tuple, device="cpu") -> Fq2:
    """(c0, c1) host ints -> Montgomery Fq2 constant (auto-broadcasting)."""
    return Fq2(mont_const(value[0], device), mont_const(value[1], device))


def fq2_zero(batch_shape=(), device="cpu") -> Fq2:
    z = L.mont_zero(batch_shape, device)
    return Fq2(z, z)


def fq2_one(batch_shape=(), device="cpu") -> Fq2:
    return Fq2(L.mont_one(batch_shape, device), L.mont_zero(batch_shape, device))


def fq6_zero(batch_shape=(), device="cpu") -> Fq6:
    z = fq2_zero(batch_shape, device)
    return Fq6(z, z, z)


def fq6_one(batch_shape=(), device="cpu") -> Fq6:
    return Fq6(fq2_one(batch_shape, device), fq2_zero(batch_shape, device),
               fq2_zero(batch_shape, device))


def fq12_zero(batch_shape=(), device="cpu") -> Fq12:
    return Fq12(fq6_zero(batch_shape, device), fq6_zero(batch_shape, device))


def fq12_one(batch_shape=(), device="cpu") -> Fq12:
    return Fq12(fq6_one(batch_shape, device), fq6_zero(batch_shape, device))


# ---------------------------------------------------------------------------
# retag helpers (loop-carrier bound stabilisation)
# ---------------------------------------------------------------------------


_RETAG_LMAX = 1 << 16  # carriers may hold one lazy-add level


def fq2_squeeze(a: Fq2) -> Fq2:
    """Conditionally vreduce components whose static bound has inflated
    (the xi-multiplication chains); no-op otherwise."""
    return Fq2(L.maybe_vreduce(a.c0), L.maybe_vreduce(a.c1))


def fq6_squeeze(a: Fq6) -> Fq6:
    return Fq6(fq2_squeeze(a.c0), fq2_squeeze(a.c1), fq2_squeeze(a.c2))


def fq12_squeeze(a: Fq12) -> Fq12:
    return Fq12(fq6_squeeze(a.c0), fq6_squeeze(a.c1))


def _retag_el(e: El, vmax: int) -> El:
    if e.lmax > _RETAG_LMAX:
        e = L.norm_limbs(e)
    return L.retag(e, vmax, _RETAG_LMAX)


def fq2_retag(a: Fq2, vmax: int = L.STD_BOUND) -> Fq2:
    return Fq2(_retag_el(a.c0, vmax), _retag_el(a.c1, vmax))


def fq6_retag(a: Fq6, vmax: int = L.STD_BOUND) -> Fq6:
    return Fq6(*[fq2_retag(c, vmax) for c in a])


def fq12_retag(a: Fq12, vmax: int = L.STD_BOUND) -> Fq12:
    return Fq12(fq6_retag(a.c0, vmax), fq6_retag(a.c1, vmax))


# ---------------------------------------------------------------------------
# Fq2 arithmetic
# ---------------------------------------------------------------------------


def fq2_add(a: Fq2, b: Fq2) -> Fq2:
    return Fq2(L.add_mod(a.c0, b.c0), L.add_mod(a.c1, b.c1))


def fq2_sub(a: Fq2, b: Fq2) -> Fq2:
    return Fq2(L.sub_mod(a.c0, b.c0), L.sub_mod(a.c1, b.c1))


def fq2_neg(a: Fq2) -> Fq2:
    return Fq2(L.neg_mod(a.c0), L.neg_mod(a.c1))


def fq2_conj(a: Fq2) -> Fq2:
    return Fq2(a.c0, L.neg_mod(a.c1))


def fq2_double(a: Fq2) -> Fq2:
    return Fq2(L.add_mod(a.c0, a.c0), L.add_mod(a.c1, a.c1))


def fq2_mul(a: Fq2, b: Fq2) -> Fq2:
    """Karatsuba: 3 leaf muls in one batched mont_mul."""
    sa = L.add_mod(a.c0, a.c1)
    sb = L.add_mod(b.c0, b.c1)
    prods = L.mont_mul(L.stack([a.c0, a.c1, sa]), L.stack([b.c0, b.c1, sb]))
    t0, t1, t2 = L.unstack(prods, 3)
    return Fq2(L.sub_mod(t0, t1), L.sub_mod(L.sub_mod(t2, t0), t1))


def fq2_sq(a: Fq2) -> Fq2:
    """(a0+a1)(a0-a1) and a0*2a1 — 2 leaf muls in one call."""
    s = L.add_mod(a.c0, a.c1)
    d = L.sub_mod(a.c0, a.c1)
    prods = L.mont_mul(
        L.stack([s, a.c0]), L.stack([d, L.add_mod(a.c1, a.c1)])
    )
    t0, t1 = L.unstack(prods, 2)
    return Fq2(t0, t1)


def fq2_mul_fq(a: Fq2, s: El) -> Fq2:
    prods = L.mont_mul(L.stack([a.c0, a.c1]), L.stack([s, s]))
    t0, t1 = L.unstack(prods, 2)
    return Fq2(t0, t1)


def fq2_mul_small(a: Fq2, k: int) -> Fq2:
    return Fq2(L.mul_small(a.c0, k), L.mul_small(a.c1, k))


def fq2_mul_xi(a: Fq2) -> Fq2:
    """Multiply by xi = 9 + i: (9 c0 - c1, c0 + 9 c1)."""
    n0 = L.mul_small(a.c0, 9)
    n1 = L.mul_small(a.c1, 9)
    return Fq2(L.sub_mod(n0, a.c1), L.add_mod(a.c0, n1))


def fq2_inv(a: Fq2) -> Fq2:
    norm = L.add_mod(L.mont_sqr(a.c0), L.mont_sqr(a.c1))
    inv = L.inv_mod(norm)
    prods = L.mont_mul(
        L.stack([a.c0, L.neg_mod(a.c1)]), L.stack([inv, inv])
    )
    t0, t1 = L.unstack(prods, 2)
    return Fq2(t0, t1)


def fq2_eq(a: Fq2, b: Fq2) -> torch.Tensor:
    return L.eq(a.c0, b.c0) & L.eq(a.c1, b.c1)


def fq2_is_zero(a: Fq2) -> torch.Tensor:
    return L.is_zero(a.c0) & L.is_zero(a.c1)


def fq2_select(mask, t: Fq2, f: Fq2) -> Fq2:
    return Fq2(L.select(mask, t.c0, f.c0), L.select(mask, t.c1, f.c1))


# ---------------------------------------------------------------------------
# Fq6 arithmetic (Toom-style interpolation, 6 Fq2 muls per mul, batched)
# ---------------------------------------------------------------------------


def fq6_add(a: Fq6, b: Fq6) -> Fq6:
    return Fq6(fq2_add(a.c0, b.c0), fq2_add(a.c1, b.c1), fq2_add(a.c2, b.c2))


def fq6_sub(a: Fq6, b: Fq6) -> Fq6:
    return Fq6(fq2_sub(a.c0, b.c0), fq2_sub(a.c1, b.c1), fq2_sub(a.c2, b.c2))


def fq6_neg(a: Fq6) -> Fq6:
    return Fq6(fq2_neg(a.c0), fq2_neg(a.c1), fq2_neg(a.c2))


def fq6_mul(a: Fq6, b: Fq6) -> Fq6:
    """The host oracle's interpolation identity: 6 Fq2 muls gathered into
    one batched fq2_mul (18 leaves in one mont_mul)."""
    astack = fq2_stack(
        [a.c0, a.c1, a.c2, fq2_add(a.c1, a.c2), fq2_add(a.c0, a.c1),
         fq2_add(a.c0, a.c2)]
    )
    bstack = fq2_stack(
        [b.c0, b.c1, b.c2, fq2_add(b.c1, b.c2), fq2_add(b.c0, b.c1),
         fq2_add(b.c0, b.c2)]
    )
    t0, t1, t2, u0, u1, u2 = fq2_unstack(fq2_mul(astack, bstack), 6)
    c0 = fq2_add(t0, fq2_mul_xi(fq2_sub(fq2_sub(u0, t1), t2)))
    c1 = fq2_add(fq2_sub(fq2_sub(u1, t0), t1), fq2_mul_xi(t2))
    c2 = fq2_add(fq2_sub(fq2_sub(u2, t0), t2), t1)
    return fq6_squeeze(Fq6(c0, c1, c2))


def fq6_sq(a: Fq6) -> Fq6:
    return fq6_mul(a, a)


def fq6_mul_by_v(a: Fq6) -> Fq6:
    return Fq6(fq2_mul_xi(a.c2), a.c0, a.c1)


def fq6_mul_fq2(a: Fq6, s: Fq2) -> Fq6:
    st = fq2_stack([s, s, s])
    p0, p1, p2 = fq2_unstack(fq2_mul(fq2_stack([a.c0, a.c1, a.c2]), st), 3)
    return Fq6(p0, p1, p2)


def fq6_inv(a: Fq6) -> Fq6:
    c0 = fq2_sub(fq2_sq(a.c0), fq2_mul_xi(fq2_mul(a.c1, a.c2)))
    c1 = fq2_sub(fq2_mul_xi(fq2_sq(a.c2)), fq2_mul(a.c0, a.c1))
    c2 = fq2_sub(fq2_sq(a.c1), fq2_mul(a.c0, a.c2))
    t = fq2_add(
        fq2_add(
            fq2_mul_xi(fq2_mul(a.c2, c1)), fq2_mul_xi(fq2_mul(a.c1, c2))
        ),
        fq2_mul(a.c0, c0),
    )
    t_inv = fq2_inv(t)
    return Fq6(fq2_mul(c0, t_inv), fq2_mul(c1, t_inv), fq2_mul(c2, t_inv))


def fq6_eq(a: Fq6, b: Fq6) -> torch.Tensor:
    return fq2_eq(a.c0, b.c0) & fq2_eq(a.c1, b.c1) & fq2_eq(a.c2, b.c2)


def fq6_select(mask, t: Fq6, f: Fq6) -> Fq6:
    return Fq6(
        fq2_select(mask, t.c0, f.c0),
        fq2_select(mask, t.c1, f.c1),
        fq2_select(mask, t.c2, f.c2),
    )


# ---------------------------------------------------------------------------
# Fq12 arithmetic
# ---------------------------------------------------------------------------


def fq12_add(a: Fq12, b: Fq12) -> Fq12:
    return Fq12(fq6_add(a.c0, b.c0), fq6_add(a.c1, b.c1))


def fq12_sub(a: Fq12, b: Fq12) -> Fq12:
    return Fq12(fq6_sub(a.c0, b.c0), fq6_sub(a.c1, b.c1))


def fq12_mul(a: Fq12, b: Fq12) -> Fq12:
    """One "fq12_mul" kernel launch on CUDA tensors, else the plain body."""
    if _use_kernels(*L.tree_leaves(a), *L.tree_leaves(b)):
        return FK.fused_op(_fq12_mul_impl, "fq12_mul", a, b)
    return _fq12_mul_impl(a, b)


def fq12_sq(a: Fq12) -> Fq12:
    """One "fq12_sq" kernel launch on CUDA tensors, else the plain body."""
    if _use_kernels(*L.tree_leaves(a)):
        return FK.fused_op(_fq12_sq_impl, "fq12_sq", a)
    return _fq12_sq_impl(a)


def fq12_cyc_sq(a: Fq12) -> Fq12:
    """One "fq12_cyc_sq" kernel launch on CUDA tensors, else the plain
    body. Valid only on the cyclotomic subgroup."""
    if _use_kernels(*L.tree_leaves(a)):
        return FK.fused_op(_fq12_cyc_sq_impl, "fq12_cyc_sq", a)
    return _fq12_cyc_sq_impl(a)


def _fq12_mul_impl(a: Fq12, b: Fq12) -> Fq12:
    """Karatsuba over Fq6: 3 Fq6 muls in one batched call (54 leaves)."""
    astack = fq6_stack([a.c0, a.c1, fq6_add(a.c0, a.c1)])
    bstack = fq6_stack([b.c0, b.c1, fq6_add(b.c0, b.c1)])
    t0, t1, t2 = fq6_unstack(fq6_mul(astack, bstack), 3)
    c0 = fq6_add(t0, fq6_mul_by_v(t1))
    c1 = fq6_sub(fq6_sub(t2, t0), t1)
    return fq12_squeeze(Fq12(c0, c1))


def _fq12_sq_impl(a: Fq12) -> Fq12:
    """Complex-style squaring: t = c0 c1; c0' = (c0+c1)(c0+v c1) - t - v t;
    c1' = 2t — 2 Fq6 muls in one batched call."""
    t, u = fq6_unstack(
        fq6_mul(
            fq6_stack([a.c0, fq6_add(a.c0, a.c1)]),
            fq6_stack([a.c1, fq6_add(a.c0, fq6_mul_by_v(a.c1))]),
        ),
        2,
    )
    c0 = fq6_sub(fq6_sub(u, t), fq6_mul_by_v(t))
    c1 = fq6_add(t, t)
    return fq12_squeeze(Fq12(c0, c1))


def _fq12_cyc_sq_impl(a: Fq12) -> Fq12:
    """Granger-Scott cyclotomic squaring: 18 leaf muls vs fq12_sq's 36.

    Valid ONLY for elements of the cyclotomic subgroup (e.g. any easy-part
    output of the final exponentiation). Fq12 = Fq4[v] with Fq4 = Fq2[W],
    W = v*w, W^2 = xi: three Fq4 squarings plus the 3t +/- 2r
    recombination (Granger-Scott 2010, §3.1).
    """
    r0, r4, r3 = a.c0
    r2, r1, r5 = a.c1
    # Each Fq4 square (x + y W)^2 = (x^2 + xi y^2) + (2xy) W needs two
    # Fq2 products: tmp = x*y and s = (x+y)(x + xi y); all six products
    # gather into ONE batched fq2_mul (18 leaves).
    pairs = [(r0, r1), (r2, r3), (r4, r5)]
    lhs = fq2_stack([x for x, _ in pairs] + [fq2_add(x, y) for x, y in pairs])
    rhs = fq2_stack([y for _, y in pairs]
                    + [fq2_add(x, fq2_mul_xi(y)) for x, y in pairs])
    pa, pb, pc, sa, sb, sc = fq2_unstack(fq2_mul(lhs, rhs), 6)

    def fq4_out(tmp, s):
        even = fq2_sub(fq2_sub(s, tmp), fq2_mul_xi(tmp))  # x^2 + xi y^2
        odd = fq2_double(tmp)  # 2xy
        return even, odd

    t0, t1 = fq4_out(pa, sa)
    t2, t3 = fq4_out(pb, sb)
    t4, t5 = fq4_out(pc, sc)

    def three_plus_two(t, r):  # 3t + 2r
        x = fq2_add(t, r)
        return fq2_add(fq2_double(x), t)

    def three_minus_two(t, r):  # 3t - 2r
        x = fq2_sub(t, r)
        return fq2_add(fq2_double(x), t)

    out = Fq12(
        Fq6(
            three_minus_two(t0, r0),
            three_minus_two(t2, r4),
            three_minus_two(t4, r3),
        ),
        Fq6(
            three_plus_two(fq2_mul_xi(t5), r2),
            three_plus_two(t1, r1),
            three_plus_two(t3, r5),
        ),
    )
    return fq12_squeeze(out)


def fq12_conj(a: Fq12) -> Fq12:
    """w -> -w: the p^6 Frobenius (inverse in the cyclotomic subgroup)."""
    return Fq12(a.c0, fq6_neg(a.c1))


def fq12_neg(a: Fq12) -> Fq12:
    return Fq12(fq6_neg(a.c0), fq6_neg(a.c1))


def fq12_inv(a: Fq12) -> Fq12:
    t = fq6_sub(fq6_sq(a.c0), fq6_mul_by_v(fq6_sq(a.c1)))
    t_inv = fq6_inv(t)
    return Fq12(fq6_mul(a.c0, t_inv), fq6_neg(fq6_mul(a.c1, t_inv)))


def fq12_eq(a: Fq12, b: Fq12) -> torch.Tensor:
    return fq6_eq(a.c0, b.c0) & fq6_eq(a.c1, b.c1)


def fq12_is_one(a: Fq12) -> torch.Tensor:
    e = a.c0.c0.c0
    return fq12_eq(a, fq12_one(e.batch_shape, e.device))


def fq12_select(mask, t: Fq12, f: Fq12) -> Fq12:
    return Fq12(fq6_select(mask, t.c0, f.c0), fq6_select(mask, t.c1, f.c1))


# ---------------------------------------------------------------------------
# Frobenius endomorphism (coefficients precomputed from the host oracle)
# ---------------------------------------------------------------------------

_FROB = {
    k: (
        HF.FROB_GAMMA_V[k],
        HF.FROB_GAMMA_V2[k],
        HF.FROB_GAMMA_W[k],
        HF.fq2_mul(HF.FROB_GAMMA_V[k], HF.FROB_GAMMA_W[k]),
        HF.fq2_mul(HF.FROB_GAMMA_V2[k], HF.FROB_GAMMA_W[k]),
    )
    for k in (1, 2, 3)
}


def _fq2_frob(a: Fq2, k: int) -> Fq2:
    return a if k % 2 == 0 else fq2_conj(a)


def fq12_frob(a: Fq12, k: int) -> Fq12:
    """a^(p^k) for k in {1, 2, 3}."""
    dev = a.c0.c0.c0.device
    gv, gv2, gw, gvw, gv2w = (const_fq2(g, dev) for g in _FROB[k])
    c0 = Fq6(
        _fq2_frob(a.c0.c0, k),
        fq2_mul(_fq2_frob(a.c0.c1, k), gv),
        fq2_mul(_fq2_frob(a.c0.c2, k), gv2),
    )
    c1 = Fq6(
        fq2_mul(_fq2_frob(a.c1.c0, k), gw),
        fq2_mul(_fq2_frob(a.c1.c1, k), gvw),
        fq2_mul(_fq2_frob(a.c1.c2, k), gv2w),
    )
    return Fq12(c0, c1)


# ---------------------------------------------------------------------------
# host <-> device conversion
# ---------------------------------------------------------------------------


def fq2_from_ints(vals, device="cpu") -> Fq2:
    """(c0, c1) host ints (or nested lists of them) -> Montgomery Fq2."""
    c0, c1 = vals
    return Fq2(L.to_mont(L.from_ints(c0, device=device)),
               L.to_mont(L.from_ints(c1, device=device)))


def fq2_to_ints(a: Fq2):
    return (L.to_ints(L.from_mont(a.c0)), L.to_ints(L.from_mont(a.c1)))


def fq12_from_host(h, batch_shape=(), device="cpu") -> Fq12:
    """Host oracle Fq12 tuple -> device Fq12 (broadcast to batch_shape)."""

    def conv(x):
        return L.bcast_to(L.to_mont(L.from_ints(x, device=device)),
                          batch_shape)

    return Fq12(*[Fq6(*[Fq2(conv(c[0]), conv(c[1])) for c in six])
                  for six in h])


def fq12_to_host(a: Fq12):
    """Device Fq12 -> host oracle tuple of int arrays (canonical values)."""

    def conv(x):
        return L.to_ints(L.from_mont(x))

    return tuple(
        tuple((conv(fq2.c0), conv(fq2.c1)) for fq2 in six) for six in a
    )
