"""The port's G1 Jacobian arithmetic and GLV ladder vs the JAX package.

Limb for limb (and static bounds) on the same numpy-seeded points: the
complete addition with its edge cases (identity on either side, P == Q,
P == -Q), doubling, the batched affine conversion, the fixed-schedule
scalar ladder and the GLV Shamir ladder with the same GlvWeights. The
ladders are also checked by value against the host oracle.
"""

import numpy as np
import pytest

from bn254_tpu.constants import P, R
from bn254_tpu.curve import g1 as JG1
from bn254_tpu.curve import glv as JGLV
from bn254_tpu.curve import jacobian as JJ
from bn254_tpu.curve.ops import FqOps as JFqOps
from bn254_tpu.host import curve as HC
from bn254_tpu.utils import convert as JCV
from bn254_tpu_torch.curve import g1 as G1
from bn254_tpu_torch.curve import glv as GLV
from bn254_tpu_torch.curve import jacobian as J
from bn254_tpu_torch.curve.ops import FqOps
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.utils import convert as CV


def leaves(x):
    return [x] if hasattr(x, "vmax") else [e for c in x for e in leaves(c)]


def parts(x):
    return [(np.asarray(e.arr), e.vmax, e.lmax) for e in leaves(x)]


def carry_point(p):
    return CV.jpoint_from_numpy(parts(p))


def assert_same(jx, px):
    jl, pl = leaves(jx), leaves(px)
    assert len(jl) == len(pl)
    for j, p in zip(jl, pl):
        assert (p.vmax, p.lmax) == (j.vmax, j.lmax)
        assert np.array_equal(np.asarray(j.arr).astype(np.int64),
                              p.arr.numpy())


def host_jac(k: int, z: int):
    """[k]G1 in Jacobian coordinates with Z = z (z = 0: the identity)."""
    if z == 0:
        return HC.G1_IDENTITY
    x, y = HC.g1_to_affine(HC.g1_mul(HC.G1_ONE, k))
    return (x * z * z % P, y * z * z * z % P, z)


@pytest.fixture(scope="module")
def edge_pair():
    """p1 + p2 hits: generic, P == Q, P == -Q, p2 = O, p1 = O."""
    rng = np.random.default_rng(2027)
    z = [int(v) + 2 for v in rng.integers(1, 2**62, size=10)]
    ks = [int(v) for v in rng.integers(2, 2**62, size=4)]
    p1 = [host_jac(ks[0], z[0]), host_jac(ks[1], z[1]), host_jac(ks[2], z[2]),
          host_jac(ks[3], z[3]), HC.G1_IDENTITY]
    neg = HC.g1_neg(host_jac(ks[2], z[6]))
    p2 = [host_jac(ks[3] + 1, z[5]), host_jac(ks[1], z[7]), neg,
          HC.G1_IDENTITY, host_jac(ks[0], z[8])]
    return p1, p2


def test_add_edge_cases(edge_pair):
    h1, h2 = edge_pair
    a, b = JG1.from_host(h1), JG1.from_host(h2)
    want = JJ.add(JFqOps, a, b)
    got = J.add(FqOps, carry_point(a), carry_point(b))
    assert_same(want, got)
    aff = G1.to_host_affine(*G1.to_affine(got))
    assert aff == [HC.g1_to_affine(HC.g1_add(x, y)) for x, y in zip(h1, h2)]


def test_double(edge_pair):
    h1, _ = edge_pair
    a = JG1.from_host(h1)
    assert_same(JJ.double(JFqOps, a), J.double(FqOps, carry_point(a)))


def test_to_affine_with_identity(edge_pair):
    h1, _ = edge_pair
    a = JG1.from_host(h1)
    jx, jy, jinf = JG1.to_affine(a)
    px, py, pinf = G1.to_affine(carry_point(a))
    assert_same((jx, jy), (px, py))
    assert np.array_equal(np.asarray(jinf), pinf.numpy())
    assert pinf.numpy().tolist() == [False] * 4 + [True]


def test_scalar_mul_fixed_ladder():
    rng = np.random.default_rng(31)
    ks = [int(v) for v in rng.integers(1, 2**16, size=3)]
    pts = [host_jac(int(k) + 5, int(k) + 7) for k in rng.integers(2, 2**40, size=3)]
    a = JG1.from_host(pts)
    sk = JCV.scalars_to_device(ks)
    want = JG1.scalar_mul(a, sk, nbits=16)
    got = G1.scalar_mul(carry_point(a), CV.from_numpy(*parts(sk)[0]), nbits=16)
    assert_same(want, got)
    aff = G1.to_host_affine(*G1.to_affine(got))
    assert aff == [HC.g1_to_affine(HC.g1_mul(p, k)) for p, k in zip(pts, ks)]


def test_shamir_ladder_same_weights():
    bits = 32  # a 16-step ladder
    pairs = [(1, 0), (0xBEEF, 0x1234), (0x00FF, 0xFFFF)]
    w = JGLV.glv_weights_to_device(pairs, bits)
    pw = CV.glv_weights_from_numpy(np.asarray(w.a.arr), np.asarray(w.b.arr),
                                   bits)
    pts = [host_jac(1000 + 17 * i, 3 + i) for i in range(3)]
    a = JG1.from_host(pts)
    want = JGLV.shamir_scalar_mul(a, w)
    got = GLV.shamir_scalar_mul(carry_point(a), pw)
    assert_same(want, got)
    ws = GLV.weight_values(pw)
    assert ws == [(x + JGLV.LAMBDA * y) % R for x, y in pairs]
    aff = G1.to_host_affine(*G1.to_affine(got))
    assert aff == [HC.g1_to_affine(HC.g1_mul(p, k)) for p, k in zip(pts, ws)]


def test_glv_weight_guards():
    with pytest.raises(ValueError):
        GLV.random_glv_weights(4, bits=15)  # odd width
    with pytest.raises(ValueError):
        GLV.random_glv_weights(4, bits=254)  # bits//2 > 126
    with pytest.raises(ValueError):
        GLV.glv_weights_to_device([(1 << 8, 0)], bits=16)  # half too wide
    w = GLV.random_glv_weights(5, bits=32)
    assert (w.a.vmax, w.b.vmax, w.half_bits) == (1 << 16, 1 << 16, 16)
    a, b = L.to_ints(w.a), L.to_ints(w.b)
    assert (int(a[0]), int(b[0])) == (1, 0)
    assert all((int(x) or int(y)) for x, y in zip(a, b))


# the public G1 helpers and jacobian.from_affine, against the JAX twins
def helper_cases(edge_pair):
    h1, h2 = edge_pair
    a, b = JG1.from_host(h1), JG1.from_host(h2)
    jx, jy, jinf = JG1.to_affine(a)
    px, py, pinf = G1.to_affine(carry_point(a))
    return {
        "generator": (JG1.generator((3,)), G1.generator((3,))),
        "identity": (JG1.identity((3,)), G1.identity((3,))),
        "double": (JG1.double(a), G1.double(carry_point(a))),
        "neg": (JG1.neg(a), G1.neg(carry_point(a))),
        "from_host": (a, G1.from_host(h1)),
        "from_host_one": (JG1.from_host(h1[0]), G1.from_host(h1[0])),
        "from_affine": (JJ.from_affine(JFqOps, jx, jy),
                        J.from_affine(FqOps, px, py)),
        "from_affine_inf": (JJ.from_affine(JFqOps, jx, jy, jinf),
                            J.from_affine(FqOps, px, py, pinf)),
        "eq": (JG1.eq(a, b), G1.eq(carry_point(a), carry_point(b))),
        "eq_self": (JG1.eq(a, a), G1.eq(carry_point(a), G1.from_host(h1))),
        "is_on_curve_affine": (JG1.is_on_curve_affine(jx, jy),
                               G1.is_on_curve_affine(px, py)),
    }


HELPER_NAMES = ["generator", "identity", "double", "neg", "from_host",
                "from_host_one", "from_affine", "from_affine_inf", "eq",
                "eq_self", "is_on_curve_affine"]


@pytest.mark.parametrize("name", HELPER_NAMES)
def test_g1_helpers_match_jax(name, edge_pair):
    want, got = helper_cases(edge_pair)[name]
    if hasattr(got, "dtype"):  # a bool mask
        assert np.array_equal(np.asarray(want), got.numpy())
    else:
        assert_same(want, got)


def test_g1_helpers_by_value(edge_pair):
    h1, _ = edge_pair
    g = G1.generator()
    assert G1.to_host_affine(*G1.to_affine(
        J.JPoint(*[L.stack([c]) for c in g]))) == [
        HC.g1_to_affine(HC.G1_ONE)]
    a = G1.from_host(h1)
    assert G1.eq(G1.add(a, a), G1.double(a)).all()
    assert G1.eq(G1.add(a, G1.neg(a)), G1.identity((5,))).all()
    x, y, inf = G1.to_affine(a)  # the last point is the identity: (0, 0)
    assert G1.is_on_curve_affine(x, y).numpy().tolist() == [True] * 4 + [
        False]
    assert not G1.is_on_curve_affine(x, L.add_mod(y, L.mont_one((5,)))).any()
