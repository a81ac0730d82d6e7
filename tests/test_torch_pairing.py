"""The port's Miller loop, exp_u and pairing vs the JAX package and oracle.

Limb for limb on truncated schedules (as tests/test_bound_pinning.py
does): the Miller loop against `miller._miller_loop_scan(naf=...)` — both
digit signs plus the two Frobenius adds — and exp_u against
`final_exp._exp_u_scan(window_digits=...)` with a zero and a nonzero
window. The full-schedule pairing agrees by value with the host oracle
on points from the golden vectors of tests/data/bn256.json.
"""

import json
import os

import jax
import numpy as np
import pytest

from bn254_tpu.constants import P
from bn254_tpu.fields import limbs as JL
from bn254_tpu.fields import tower as JT
from bn254_tpu.host import curve as JHC
from bn254_tpu.host import field as HF
from bn254_tpu.host import pairing as HP
from bn254_tpu.pairing import final_exp as JFE
from bn254_tpu.pairing import miller as JM
from bn254_tpu.utils import convert as JCV
from bn254_tpu_torch.fields import tower as T
from bn254_tpu_torch.pairing import final_exp as FE
from bn254_tpu_torch.pairing import miller as M
from bn254_tpu_torch.pairing import pairing as DP
from bn254_tpu_torch.utils import convert as CV

_FIXTURE = os.path.join(os.path.dirname(__file__), "data", "bn256.json")


def leaves(x):
    return [x] if hasattr(x, "vmax") else [e for c in x for e in leaves(c)]


def parts(x):
    return [(np.asarray(e.arr), e.vmax, e.lmax) for e in leaves(x)]


def assert_same(jx, px):
    jl, pl = leaves(jx), leaves(px)
    assert len(jl) == len(pl)
    for j, p in zip(jl, pl):
        assert (p.vmax, p.lmax) == (j.vmax, j.lmax)
        assert np.array_equal(np.asarray(j.arr).astype(np.int64),
                              p.arr.numpy())


def host_values(f):
    """Port Fq12 -> list of host oracle Fq12 tuples, one per batch row."""
    h = T.fq12_to_host(f)
    n = len(np.ravel(h[0][0][0]))
    return [
        tuple(tuple((int(np.ravel(c0)[i]), int(np.ravel(c1)[i]))
                    for c0, c1 in six) for six in h)
        for i in range(n)
    ]


def test_miller_truncated_matches_scan():
    g1 = [JHC.g1_mul(JHC.G1_ONE, 3 + 5 * i) for i in range(2)]
    g2 = [JHC.g2_mul(JHC.G2_ONE, 7 + 2 * i) for i in range(2)]
    px, py = JCV.g1_batch_to_device_affine(g1)
    qx, qy = JCV.g2_batch_to_device_affine(g2)
    naf = (1, 0, -1)  # both add signs and a doubling-only digit
    scan = jax.jit(lambda a, b, c, d: JM._miller_loop_scan(a, b, c, d, naf=naf))
    want = scan(px, py, qx, qy)
    got = M.miller_loop(CV.from_numpy(*parts(px)[0]),
                        CV.from_numpy(*parts(py)[0]),
                        CV.fq2_from_numpy(parts(qx)),
                        CV.fq2_from_numpy(parts(qy)), naf=naf)
    assert_same(want, got)


def test_exp_u_truncated_matches_scan():
    rng = np.random.default_rng(20260820)
    hs = []
    for _ in range(2):
        f = tuple(tuple((int(rng.integers(1, 2**62)) ** 4 % P,
                         int(rng.integers(1, 2**62)) ** 4 % P)
                        for _ in range(3)) for _ in range(2))
        g = HF.fq12_mul(HF.fq12_conj(f), HF.fq12_inv(f))
        hs.append(HF.fq12_mul(HF.fq12_frob(g, 2), g))  # cyclotomic

    def conv(i, j, k):
        return JL.to_mont(JL.from_ints([h[i][j][k] for h in hs]))

    dev = JT.Fq12(*[JT.Fq6(*[JT.Fq2(conv(i, j, 0), conv(i, j, 1))
                             for j in range(3)]) for i in range(2)])
    windows = tuple(JFE._U_WINDOWS[:2])
    assert 0 in windows and any(windows)
    scan = jax.jit(lambda f: JFE._exp_u_scan(f, window_digits=windows))
    want = scan(dev)
    got = FE.exp_u(CV.fq12_from_numpy(parts(dev)), window_digits=windows)
    assert_same(want, got)
    # by value: f^(u prefix) with the prefix bits the windows encode
    e = 1
    for w in windows:
        e = 4 * e + w
    assert all(HF.fq12_eq(a, HF.fq12_pow(h, e))
               for a, h in zip(host_values(got), hs))


@pytest.fixture(scope="module")
def golden_points():
    """Two golden scalar-mul vectors: X and [s]X (go-ethereum fixture)."""
    with open(_FIXTURE) as fh:
        vec = json.load(fh)["mul"][0]
    x, y, s = int(vec["x"], 16), int(vec["y"], 16), int(vec["scalar"], 16)
    res = vec["result"]
    sx = (int(res[:64], 16), int(res[64:], 16))
    assert JHC.g1_to_affine(JHC.g1_mul(JHC.g1_from_affine((x, y)), s)) == sx
    return (x, y), sx, s


def test_full_pairing_matches_oracle_and_bilinear(golden_points):
    """e([s]X, Q) and e(X, [s]Q) in one batched port pairing: each equals
    the host oracle's e([s]X, Q), by value."""
    xa, sxa, s = golden_points
    q = JHC.g2_mul(JHC.G2_ONE, 5)
    sq = JHC.g2_mul(q, s)
    px, py = CV.g1_batch_to_device_affine(
        [JHC.g1_from_affine(sxa), JHC.g1_from_affine(xa)])
    qx, qy = CV.g2_batch_to_device_affine([q, sq])
    got = host_values(DP.pairing(px, py, qx, qy))
    want = HP.pairing(JHC.g1_from_affine(sxa), q)
    assert HF.fq12_eq(got[0], want) and HF.fq12_eq(got[1], want)
    assert not HF.fq12_eq(want, HF.FQ12_ONE)


def test_miller_product_truncated_matches_jax(monkeypatch):
    """`pairing.miller_product` on a 2-pair axis against the JAX twin, both
    Miller loops cut to the truncated schedule."""
    from bn254_tpu.pairing import pairing as JP
    from bn254_tpu_torch.fields import limbs as L

    naf = (1, -1)
    monkeypatch.setattr(JM, "miller_loop", lambda xp, yp, qx, qy, inf_mask=None:
                        JM._miller_loop_scan(xp, yp, qx, qy, inf_mask, naf=naf))
    monkeypatch.setattr(M, "_ATE_NAF", naf)
    g1 = [JHC.g1_mul(JHC.G1_ONE, 11 + 4 * i) for i in range(4)]
    g2 = [JHC.g2_mul(JHC.G2_ONE, 3 + 9 * i) for i in range(4)]
    px, py = JCV.g1_batch_to_device_affine(g1)
    qx, qy = JCV.g2_batch_to_device_affine(g2)

    def pairs(x):  # (18, 4) -> (18, 2 pairs, 2 batch)
        return jax.tree_util.tree_map(lambda a: a.reshape(18, 2, 2), x)

    want = jax.jit(JP.miller_product)(*map(pairs, (px, py, qx, qy)))

    def carry(x):
        ps = [(np.asarray(e.arr).reshape(18, 2, 2), e.vmax, e.lmax)
              for e in leaves(x)]
        return (CV.from_numpy(*ps[0]) if len(ps) == 1
                else CV.fq2_from_numpy(ps))

    got = DP.miller_product(*map(carry, (px, py, qx, qy)))
    assert_same(want, got)
    assert L.tree_leaves(got)[0].batch_shape == (2,)
