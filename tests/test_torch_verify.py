"""The port's fused batch verification vs the JAX package (the slice whole).

B = 4 valid (H(m), sig, pk) tuples with fixed GLV weights go through both
packages' fused tier: the stage-A points and the `_miller_reduce` Fq12
agree limb for limb, the full check accepts in both, and with one
signature tampered it rejects in both. tests/test_torch_adaptive.py
covers the adaptive tier and its independent fallback (and runs the
port's whole `verify_batch_fused` on the valid batch).
"""

import numpy as np
import pytest
import torch

from bn254_tpu.curve import glv as JGLV
from bn254_tpu.dist import batch_verify as JBV
from bn254_tpu.hash.tai import hash_to_g1
from bn254_tpu.host import curve as HC
from bn254_tpu.utils import convert as JCV
from bn254_tpu_torch.dist import batch_verify as BV
from bn254_tpu_torch.fields import tower as T
from bn254_tpu_torch.pairing import final_exp as FE
from bn254_tpu_torch.utils import convert as CV

B = 4
BITS = 16  # an 8-step GLV ladder keeps the CPU run short
PAIRS = [(1, 0), (0x5A, 0xC3), (0x01, 0xFF), (0xE7, 0x00)]


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


def to_port(hx, hy, sx, sy, pqx, pqy):
    el = lambda e: CV.from_numpy(*parts(e)[0])
    return (el(hx), el(hy), el(sx), el(sy), CV.fq2_from_numpy(parts(pqx)),
            CV.fq2_from_numpy(parts(pqy)))


@pytest.fixture(scope="module")
def batch():
    msgs = [b"tv-%d" % i for i in range(B)]
    sks = [1000 + 7 * i for i in range(B)]
    hpts = [hash_to_g1(m) for m in msgs]
    sigs = [HC.g1_mul(h, k) for h, k in zip(hpts, sks)]
    pks = [HC.g2_mul(HC.G2_ONE, k) for k in sks]
    bad = list(sigs)
    bad[2] = HC.g1_mul(sigs[2], 3)
    hx, hy = JCV.g1_batch_to_device_affine(hpts)
    pqx, pqy = JCV.g2_batch_to_device_affine(pks)
    jw = JGLV.glv_weights_to_device(PAIRS, BITS)
    pw = CV.glv_weights_from_numpy(np.asarray(jw.a.arr), np.asarray(jw.b.arr),
                                   BITS)
    good = (hx, hy, *JCV.g1_batch_to_device_affine(sigs), pqx, pqy)
    tampered = (hx, hy, *JCV.g1_batch_to_device_affine(bad), pqx, pqy)
    return good, tampered, jw, pw


# One test, in a fresh subprocess (the `isolated` marker of
# tests/conftest.py): it compiles the JAX staged pipeline's big programs,
# which must not share an XLA:CPU process with other such compiles (the
# crash tests/test_dist_verify.py isolates for the same reason).
@pytest.mark.isolated
def test_fused_tier_matches_jax(batch):
    """Stage A points and the `_miller_reduce` Fq12 limb for limb; the full
    check accepts the valid batch and rejects the tampered one in both."""
    good, tampered, jw, pw = batch
    jpts = JBV._fused_points_jit(*good, jw, nbits=BITS // 2)
    jf = JBV._miller_reduce_jit(*jpts)
    with torch.inference_mode():
        ppts = BV._fused_points(*to_port(*good), pw, BITS // 2)
        pf = BV._miller_reduce(*ppts)
    assert_same(jpts[:4], ppts[:4])
    assert np.array_equal(np.asarray(jpts[4]), ppts[4].numpy())
    assert_same(jf, pf)

    # the port finishes its stage-B output as verify_batch_fused does
    assert bool(JBV.verify_batch_fused_staged(*good, jw))
    with torch.inference_mode():
        assert bool(T.fq12_is_one(FE.final_exp(pf)))

    assert not bool(JBV.verify_batch_fused_staged(*tampered, jw))
    assert not bool(BV.verify_batch_fused(*to_port(*tampered), pw))


# the fused check's launches per key at B=4 in each loop form (the knob
# `config.unroll_static_loops`); the keys left out are 0
_MILLER_UNROLLED = {"miller_dbl_body": 65, "miller_add_body": 23}
_MILLER_SCAN = {"g2_dbl_step": 65, "g2_add_step": 23, "fq12_mul_line": 88,
                "fq12_sq": 65}
FUSED_CHECK_LAUNCHES = {
    True: {
        **_MILLER_UNROLLED,  # NAF + 2 Frobenius
        "expu_step": 69, "expu_sq2": 24,  # 3 exp_u x 23 / 8 windows
        # the B+1 = 5 row product tree 3, the easy part 2, three exp_u
        # tables 3, the hard part 13; the tables 3 and the hard part 4
        "fq12_mul": 21, "fq12_cyc_sq": 7,
        # two Fp inversions (to affine, fq12_inv), p - 2 in 3-bit windows:
        # 66 nonzero and 18 zero each
        "el_pow_step_mul": 132, "el_pow_step_sq": 36,
        "glv_dbl_add": BITS // 2,  # one ladder step per weight-half bit
        "g1_add": 2,  # the signature tree-sum's levels over B = 4 rows
    },
    # the scan forms: one launch per Miller step op, per exp_u window two
    # cyclotomic squares and one product (3 x 31 windows); the powers and
    # the GLV ladder leaf by leaf; the tree-sum's levels as with the knob
    False: {**_MILLER_SCAN, "fq12_mul": 21 + 93, "fq12_cyc_sq": 7 + 3 * 62,
            "g1_add": 2},
}


@pytest.mark.isolated
@pytest.mark.parametrize("unroll", [True, False])
def test_kernel_composition_matches_jax(batch, monkeypatch, unroll):
    """Kernels forced on (`tower._on_card`): the fused and adaptive tiers
    run the card's composition in each configuration of
    `config.unroll_static_loops` (every Fq12 op and the Miller loop's
    digits or step ops through `fused_op`; under the knob also every power,
    GLV ladder step and exp_u window, the fallback through pair2, without
    it the stacked fallback) with the plain bodies, and give JAX's answers.
    JAX's adaptive tier on the tampered batch rejects in its fused check
    (above) and gives its fallback's bools, which
    tests/test_torch_independent.py holds to EXPECTED against
    `verify_batch_independent_staged`."""
    from bn254_tpu_torch import config as C
    from bn254_tpu_torch.kernels import fused as FK
    from test_torch_independent import EXPECTED

    calls = dict.fromkeys(FK.KERNELS, 0)
    fused_op = FK.fused_op

    def counted(fn, key, *args):
        calls[key] += 1
        return fused_op(fn, key, *args)

    monkeypatch.setattr(C, "DEFAULT", C.DEFAULT.replace(
        unroll_static_loops=unroll))
    monkeypatch.setattr(T, "_on_card", lambda els: True)
    monkeypatch.setattr(FK, "fused_op", counted)
    good, tampered, _, pw = batch
    assert bool(BV.verify_batch_fused(*to_port(*good), pw))
    assert calls == {**dict.fromkeys(FK.KERNELS, 0),
                     **FUSED_CHECK_LAUNCHES[unroll]}
    calls.update(dict.fromkeys(calls, 0))
    got = BV.verify_batch_adaptive(*to_port(*tampered), weights=pw)
    assert got.tolist() == EXPECTED
    # the fused check, then the independent fallback: pair2 under the
    # knob, else the two pairs stacked through the scan-form Miller loop
    pair2 = (calls["miller_dbl_body2"], calls["miller_add_body2"])
    if unroll:
        assert calls["miller_dbl_body"] == 65 and pair2 == (65, 23)
    else:
        assert {k: calls[k] for k in _MILLER_SCAN} == {
            k: 2 * v for k, v in _MILLER_SCAN.items()}
        assert pair2 == (0, 0)


def test_weight_forms_are_validated():
    """GlvWeights, PlainWeights and host ints resolve; a raw El or a weight
    wider than the ladder is refused (it would weaken the forgery bound)."""
    jw = JGLV.glv_weights_to_device(PAIRS, BITS)
    pw = CV.glv_weights_from_numpy(np.asarray(jw.a.arr), np.asarray(jw.b.arr),
                                   BITS)
    w, nb = BV._resolve_weights(pw, None, "cpu")
    assert nb == BITS // 2 and w.a.vmax == 1 << (BITS // 2)
    plain = BV.weights_to_device([1, 0xFFFF], bits=16)
    w, nb = BV._resolve_weights(plain, None, "cpu")
    assert nb == 16 and w.vmax == 1 << 256
    w, nb = BV._resolve_weights([1, 2, 3], 8, "cpu")
    assert nb == 8 and w.arr.shape == (18, 3)
    with pytest.raises(ValueError):
        BV._resolve_weights([1, 1 << 8], 8, "cpu")
    with pytest.raises(ValueError):
        BV.weights_to_device([1 << 16], bits=16)
    with pytest.raises(TypeError):
        BV._resolve_weights(w, 8, "cpu")
    with pytest.raises(ValueError):
        CV.glv_weights_from_numpy(np.asarray(jw.a.arr), np.asarray(jw.b.arr),
                                  BITS // 2)  # halves wider than 4 bits
