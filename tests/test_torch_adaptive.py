"""The port's adaptive tier against the JAX package's answer.

JAX's `verify_batch_adaptive` is its fused check (held against the port's
in tests/test_torch_verify.py on this same batch: both reject the tampered
one) followed, on rejection, by `verify_batch_independent_staged`, whose
bools on this batch tests/test_torch_independent.py pins to EXPECTED next
to the port's independent tier. Here the port's `verify_batch_adaptive`
runs whole — fused pre-check, then its own fallback — and must give
EXPECTED on the tampered batch and all True on the valid one. The split
keeps each file's JAX compiles in a process of their own.
"""

import numpy as np
import pytest

from bn254_tpu.curve import glv as JGLV
from bn254_tpu.hash.tai import hash_to_g1
from bn254_tpu.host import curve as HC
from bn254_tpu.utils import convert as JCV
from bn254_tpu_torch.dist import batch_verify as BV
from bn254_tpu_torch.utils import convert as CV
from test_torch_independent import EXPECTED  # signature 2 tampered

B = 4
BITS = 16
PAIRS = [(1, 0), (0x5A, 0xC3), (0x01, 0xFF), (0xE7, 0x00)]


def parts(e):
    els = [e] if hasattr(e, "vmax") else e
    return [(np.asarray(x.arr), x.vmax, x.lmax) for x in els]


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
    return good, tampered, pw


def test_adaptive_tampered_flags_the_tampered_tuple(batch):
    _, tampered, pw = batch
    res = BV.verify_batch_adaptive(*to_port(*tampered), weights=pw, defer=True)
    assert not bool(res._ok_host)  # the fused pre-check rejected it
    assert np.asarray(res).tolist() == EXPECTED


def test_adaptive_valid_batch_deferred(batch):
    good, _, pw = batch
    res = BV.verify_batch_adaptive(*to_port(*good), weights=pw, defer=True)
    assert isinstance(res, BV.AdaptiveResult)
    assert res.per_tuple.shape == (B,)
    assert np.asarray(res).tolist() == [True] * B
