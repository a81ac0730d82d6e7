"""The port's limb engine and tower fields vs the JAX package, limb for limb.

The same numpy-seeded inputs (B = 3) go through the JAX function and its
bn254_tpu_torch counterpart (fed by the carry-across `from_numpy`), and
the outputs must agree in every limb AND in their static (vmax, lmax)
bounds — the bounds decide every later normalisation, so equal values
with different bounds would diverge downstream.
"""

import zlib

import numpy as np
import pytest
import torch

from bn254_tpu.constants import P
from bn254_tpu.fields import limbs as JL
from bn254_tpu.fields import tower as JT
from bn254_tpu.host import field as HF
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.fields import tower as T
from bn254_tpu_torch.utils import convert as CV

B = 3


def leaves(x):
    return [x] if hasattr(x, "vmax") else [e for c in x for e in leaves(c)]


def carry(x):
    """JAX El / Fq2 / Fq12 -> the port's, via the carry-across functions."""
    parts = [(np.asarray(e.arr), e.vmax, e.lmax) for e in leaves(x)]
    if len(parts) == 1:
        return CV.from_numpy(*parts[0])
    if len(parts) == 2:
        return CV.fq2_from_numpy(parts)
    return CV.fq12_from_numpy(parts)


def assert_same(jx, px):
    jl, pl = leaves(jx), leaves(px)
    assert len(jl) == len(pl)
    for j, p in zip(jl, pl):
        assert (p.vmax, p.lmax) == (j.vmax, j.lmax)
        assert np.array_equal(np.asarray(j.arr).astype(np.int64),
                              p.arr.numpy())


def rand_ints(rng, n=B):
    return [int.from_bytes(rng.bytes(32), "little") % P for _ in range(n)]


def mont(rng):
    return JL.to_mont(JL.from_ints(rand_ints(rng)))


def lazy(rng):
    """A limb- and value-lazy element: the sum of two Montgomery values."""
    return JL.add_mod(mont(rng), mont(rng))


def fq12(rng):
    return JT.Fq12(*[JT.Fq6(*[JT.Fq2(mont(rng), mont(rng)) for _ in range(3)])
                     for _ in range(2)])


@pytest.fixture
def rng(request):
    return np.random.default_rng(zlib.crc32(request.node.name.encode()))


UNARY = {
    "neg_mod": (JL.neg_mod, L.neg_mod),
    "canon": (JL.canon, L.canon),
    "norm_limbs": (JL.norm_limbs, L.norm_limbs),
    "mul_small_9": (lambda a: JL.mul_small(a, 9), lambda a: L.mul_small(a, 9)),
    "vreduce": (JL.vreduce, L.vreduce),
    "from_mont": (JL.from_mont, L.from_mont),
    "to_mont": (lambda a: JL.to_mont(JL.canon(a)),
                lambda a: L.to_mont(L.canon(a))),
    "pow_fixed_small": (lambda a: JL.pow_fixed(a, 0b101100111),
                        lambda a: L.pow_fixed(a, 0b101100111)),
}


@pytest.mark.parametrize("name", sorted(UNARY))
def test_unary_ops(name, rng):
    jf, pf = UNARY[name]
    a = lazy(rng)
    assert_same(jf(a), pf(carry(a)))


@pytest.mark.parametrize("order", ["lazy-mont", "mont-lazy", "lazy-lazy"])
def test_sub_mod(order, rng):
    pick = {"lazy": lazy, "mont": mont}
    a, b = (pick[k](rng) for k in order.split("-"))
    assert_same(JL.sub_mod(a, b), L.sub_mod(carry(a), carry(b)))


def test_compare_ops(rng):
    a = lazy(rng)
    b = JL.El(a.arr, a.vmax, a.lmax)
    c = mont(rng)
    pa, pc = carry(a), carry(c)
    for m in (P, 2 * P, 5 * P):
        assert np.array_equal(np.asarray(JL.lt_const(a, m)),
                              L.lt_const(pa, m).numpy())
        assert_same(JL.cond_sub(a, m), L.cond_sub(pa, m))
    assert L.eq(pa, carry(b)).all()
    assert np.array_equal(np.asarray(JL.eq(a, c)), L.eq(pa, pc).numpy())
    assert np.array_equal(np.asarray(JL.is_zero(a)), L.is_zero(pa).numpy())
    mask = np.array([True, False, True])
    assert_same(JL.select(mask, a, c), L.select(torch.from_numpy(mask), pa, pc))


def test_inv_mod(rng):
    a = mont(rng)
    want = JL.inv_mod(a)
    got = L.inv_mod(carry(a))
    assert_same(want, got)
    vals = JL.to_ints(JL.from_mont(a))
    assert [int(v) for v in L.to_ints(L.from_mont(got))] == [
        pow(int(v), -1, P) for v in vals]


def test_sqrt_candidate(rng):
    a = mont(rng)
    sq = JL.mont_sqr(a)  # a QR, so the candidate is a root
    want = JL.sqrt_candidate(sq)
    got = L.sqrt_candidate(carry(sq))
    assert_same(want, got)
    assert L.eq(L.mont_sqr(got), carry(sq)).all()


def test_fq12_mul(rng):
    a, b = fq12(rng), fq12(rng)
    assert_same(JT.fq12_mul(a, b), T.fq12_mul(carry(a), carry(b)))


def test_fq12_sq(rng):
    a = fq12(rng)
    assert_same(JT.fq12_sq(a), T.fq12_sq(carry(a)))


def test_fq12_inv(rng):
    a = fq12(rng)
    want = JT.fq12_inv(a)
    got = T.fq12_inv(carry(a))
    assert_same(want, got)
    one = T.fq12_mul(got, carry(a))
    assert T.fq12_is_one(one).all()


@pytest.mark.parametrize("k", [1, 2, 3])
def test_fq12_frob(k, rng):
    a = fq12(rng)
    want = JT.fq12_frob(a, k)
    got = T.fq12_frob(carry(a), k)
    assert_same(want, got)
    h0 = tuple(tuple((int(c0[0]), int(c1[0])) for c0, c1 in six)
               for six in JT.fq12_to_host(a))
    g0 = tuple(tuple((int(c0[0]), int(c1[0])) for c0, c1 in six)
               for six in T.fq12_to_host(got))
    assert HF.fq12_eq(g0, HF.fq12_frob(h0, k))


def test_fq12_cyc_sq_on_easy_part_output(rng):
    """Granger-Scott squaring is valid on the cyclotomic subgroup only:
    feed it an easy-part image, f^((p^6-1)(p^2+1))."""
    f = fq12(rng)
    g = JT.fq12_mul(JT.fq12_conj(f), JT.fq12_inv(f))
    e = JT.fq12_retag(JT.fq12_mul(JT.fq12_frob(g, 2), g))
    want = JT.fq12_cyc_sq(e)
    got = T.fq12_cyc_sq(carry(e))
    assert_same(want, got)
    assert T.fq12_eq(got, T.fq12_sq(carry(e))).all()


def fq6(rng):
    return JT.Fq6(*[JT.Fq2(mont(rng), mont(rng)) for _ in range(3)])


def host_fq12(rng):
    return tuple(tuple((int(v), int(w)) for v, w in
                       zip(rand_ints(rng, 3), rand_ints(rng, 3)))
                 for _ in range(2))


# the public helpers of limbs.py and tower.py that no path above reaches:
# each builds its inputs from rng and returns (JAX output, port output)
HELPERS = {
    "limbs.to_int": lambda rng: (
        lambda a: (JL.to_int(a), L.to_int(carry(a))))(lazy(rng)),
    "limbs.double_mod": lambda rng: (
        lambda a: (JL.double_mod(a), L.double_mod(carry(a))))(lazy(rng)),
    "tower.fq12_zero": lambda rng: (JT.fq12_zero((B,)), T.fq12_zero((B,))),
    "tower.fq6_mul_fq2": lambda rng: (
        lambda a, s: (JT.fq6_mul_fq2(a, s),
                      T.fq6_mul_fq2(carry_fq6(a), carry(s))))(
        fq6(rng), JT.Fq2(mont(rng), mont(rng))),
    "tower.fq12_add": lambda rng: (
        lambda a, b: (JT.fq12_add(a, b), T.fq12_add(carry(a), carry(b))))(
        fq12(rng), fq12(rng)),
    "tower.fq12_sub": lambda rng: (
        lambda a, b: (JT.fq12_sub(a, b), T.fq12_sub(carry(a), carry(b))))(
        fq12(rng), fq12(rng)),
    "tower.fq12_neg": lambda rng: (
        lambda a: (JT.fq12_neg(a), T.fq12_neg(carry(a))))(fq12(rng)),
    "tower.fq2_from_ints": lambda rng: (
        lambda v: (JT.fq2_from_ints(v), T.fq2_from_ints(v)))(
        (rand_ints(rng), rand_ints(rng))),
    "tower.fq12_from_host": lambda rng: (
        lambda h: (JT.fq12_from_host(h, (B,)), T.fq12_from_host(h, (B,))))(
        host_fq12(rng)),
}


def carry_fq6(a):
    return T.Fq6(*[carry(c) for c in a])


@pytest.mark.parametrize("name", sorted(HELPERS))
def test_public_helpers_match_jax(name, rng):
    want, got = HELPERS[name](rng)
    if isinstance(want, int):
        assert got == want
    else:
        assert_same(want, got)


def test_fq2_to_ints_round_trip(rng):
    v = (rand_ints(rng), rand_ints(rng))
    a = JT.fq2_from_ints(v)
    want = JT.fq2_to_ints(a)
    got = T.fq2_to_ints(carry(a))
    assert [list(map(int, c)) for c in got] == \
        [list(map(int, c)) for c in want] == [list(c) for c in v]
    assert [list(map(int, c)) for c in T.fq2_to_ints(T.fq2_from_ints(v))] \
        == [list(c) for c in v]
