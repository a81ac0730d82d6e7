"""The port's device G2 (`bn254_tpu_torch/curve/g2.py`) vs the JAX package.

Every function of the module, limb for limb and bound for bound, against
`bn254_tpu.curve.g2` on the same host points (made from a numpy seed; the
edge lanes P + P, P + (-P), O + Q and P + O among them), the ladder
`scalar_mul` at 16 bits; one full 256-bit `scalar_mul` of the generator
against the host oracle, as tests/test_device_curve.py holds the JAX one
(its products over the montmul kernel's arithmetic built with g++);
`is_on_curve_affine` against the host oracle (the JAX function raises, see
its docstring).
"""

import ctypes

import numpy as np
import pytest
import torch

from bn254_tpu.curve import g2 as JG2
from bn254_tpu.fields import limbs as JL
from bn254_tpu_torch.constants import NLIMBS, P
from bn254_tpu_torch.curve import g2 as G2
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.host import curve as HC
from bn254_tpu_torch.host import field as HF
from bn254_tpu_torch.kernels import montmul as MK
from bn254_tpu_torch.utils import convert as CV
from test_torch_fused_host import host_lib  # noqa: F401


def leaves(x):
    return [x] if hasattr(x, "vmax") else [e for c in x for e in leaves(c)]


def assert_same(jx, px):
    jl, pl = leaves(jx), leaves(px)
    assert len(jl) == len(pl)
    for j, p in zip(jl, pl):
        assert (p.vmax, p.lmax) == (j.vmax, j.lmax)
        assert np.array_equal(np.asarray(j.arr).astype(np.int64),
                              p.arr.numpy())


def host_jac(k: int, z):
    """[k]G2 in Jacobian coordinates with Z = z (an Fq2 pair)."""
    x, y = HC.g2_to_affine(HC.g2_mul(HC.G2_ONE, k))
    z2 = HF.fq2_mul(z, z)
    return (HF.fq2_mul(x, z2), HF.fq2_mul(y, HF.fq2_mul(z2, z)), z)


@pytest.fixture(scope="module")
def edge_pair():
    """p1 + p2 hits: generic, P == Q, P == -Q, p2 = O, p1 = O."""
    rng = np.random.default_rng(2028)
    zs = [(int(a) % P, int(b) % P) for a, b in
          rng.integers(1, 2**62, size=(10, 2))]
    ks = [int(v) for v in rng.integers(2, 2**62, size=4)]
    p1 = [host_jac(ks[0], zs[0]), host_jac(ks[1], zs[1]),
          host_jac(ks[2], zs[2]), host_jac(ks[3], zs[3]), HC.G2_IDENTITY]
    p2 = [host_jac(ks[3] + 1, zs[5]), host_jac(ks[1], zs[7]),
          HC.g2_neg(host_jac(ks[2], zs[6])), HC.G2_IDENTITY,
          host_jac(ks[0], zs[8])]
    return p1, p2


def both(points):
    """The JAX package's and the port's `from_host` of the same points."""
    return JG2.from_host(points), G2.from_host(points)


def test_from_host_generator_identity(edge_pair):
    h1, _ = edge_pair
    j, p = both(h1)
    assert_same(j, p)
    assert_same(JG2.from_host(h1[0]), G2.from_host(h1[0]))  # one point
    assert_same(JG2.generator((3,)), G2.generator((3,)))
    assert_same(JG2.identity((3,)), G2.identity((3,)))


def test_add_double_neg_eq(edge_pair):
    h1, h2 = edge_pair
    (j1, p1), (j2, p2) = both(h1), both(h2)
    got = G2.add(p1, p2)
    assert_same(JG2.add(j1, j2), got)
    assert_same(JG2.double(j1), G2.double(p1))
    assert_same(JG2.neg(j1), G2.neg(p1))
    assert G2.to_host_affine(got) == [
        HC.g2_to_affine(HC.g2_add(x, y)) for x, y in zip(h1, h2)]
    assert np.array_equal(np.asarray(JG2.eq(j1, j2)), G2.eq(p1, p2).numpy())
    # the same points in other coordinates on lanes 1 and 2, both the
    # identity on lane 4
    same = G2.eq(p1, G2.from_host([h2[0], h2[1], h1[2], h2[3], h1[4]]))
    assert same.numpy().tolist() == [False, True, True, False, True]


def test_to_affine_and_host_affine(edge_pair):
    h1, _ = edge_pair
    j, p = both(h1)
    jx, jy, jinf = JG2.to_affine(j)
    px, py, pinf = G2.to_affine(p)
    assert_same((jx, jy), (px, py))
    assert np.array_equal(np.asarray(jinf), pinf.numpy())
    assert G2.to_host_affine(p) == JG2.to_host_affine(j)
    assert G2.to_host_affine(p) == [HC.g2_to_affine(h) for h in h1]
    assert G2.to_host_affine(G2.from_host(h1[1])) == HC.g2_to_affine(h1[1])


def test_is_on_curve_affine(edge_pair):
    h1, _ = edge_pair
    px, py, _ = G2.to_affine(G2.from_host(h1[:4]))
    assert G2.is_on_curve_affine(px, py).numpy().tolist() == [True] * 4
    # y moved by one: off the curve, as the host oracle says
    aff = HC.g2_to_affine(h1[0])
    off = (aff[0], ((aff[1][0] + 1) % P, aff[1][1]))
    assert not HC.g2_is_on_curve(off)
    dx, dy, _ = G2.to_affine(G2.from_host([HC.g2_from_affine(off)]))
    assert G2.is_on_curve_affine(dx, dy).numpy().tolist() == [False]


def test_scalar_mul_16_bits(edge_pair):
    h1, _ = edge_pair
    rng = np.random.default_rng(33)
    ks = [int(v) for v in rng.integers(1, 2**16, size=4)] + [0x5A5A]
    sk = JL.from_ints(ks)
    j, p = both(h1)
    want = JG2.scalar_mul(j, sk, nbits=16)
    got = G2.scalar_mul(p, CV.from_numpy(np.asarray(sk.arr), sk.vmax,
                                         sk.lmax), nbits=16)
    assert_same(want, got)
    assert G2.to_host_affine(got) == [
        HC.g2_to_affine(HC.g2_mul(h, k)) for h, k in zip(h1, ks)]


@torch.inference_mode()
def test_scalar_mul_256_bits_matches_oracle(host_lib, monkeypatch):
    """The full ladder with its products over `cios`, the montmul
    kernel's arithmetic, from the g++ build of `fused.cu` (bit-exact with
    the plain leaf, tests/test_torch_fused_host.py; the card runs the
    same limbs), as the card would run it."""
    leaf = host_lib.bn254_host_cios
    leaf.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]

    def montmul(a, b):
        a, b = torch.broadcast_tensors(a, b)
        n = a.numel() // NLIMBS
        a2, b2 = (x.reshape(NLIMBS, n).contiguous() for x in (a, b))
        out = torch.empty((NLIMBS, n), dtype=torch.int64)
        leaf(a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n)
        return out.reshape(a.shape)

    monkeypatch.setattr(MK, "montmul", montmul)
    sks = [0x1AB1126FF2E37C6E6EDDEA943CCB3A48F83B380B856424EE552E113595525565,
           5]
    got = G2.to_host_affine(G2.scalar_mul(G2.generator((2,)),
                                          L.from_ints(sks)))
    assert got == [HC.g2_to_affine(HC.g2_mul(HC.G2_ONE, k)) for k in sks]
