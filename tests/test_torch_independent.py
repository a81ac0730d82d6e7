"""The port's independent tier vs the JAX package's, on a tampered batch.

The JAX side is `verify_batch_independent_staged`, the fallback JAX's
`verify_batch_adaptive` runs on a rejected batch; its bools are pinned to
EXPECTED, which tests/test_torch_adaptive.py holds the port's adaptive
tier to. It runs in a fresh subprocess (`isolated`): it compiles the JAX
staged pipeline's big programs (see tests/test_torch_verify.py).
"""

import numpy as np
import pytest

from bn254_tpu.dist import batch_verify as JBV
from bn254_tpu.hash.tai import hash_to_g1
from bn254_tpu.host import curve as HC
from bn254_tpu.utils import convert as JCV
from bn254_tpu_torch.dist import batch_verify as BV
from bn254_tpu_torch.utils import convert as CV

B = 4
EXPECTED = [True, True, False, True]  # signature 2 tampered


def parts(e):
    els = [e] if hasattr(e, "vmax") else e
    return [(np.asarray(x.arr), x.vmax, x.lmax) for x in els]


def to_port(hx, hy, sx, sy, pqx, pqy):
    el = lambda e: CV.from_numpy(*parts(e)[0])
    return (el(hx), el(hy), el(sx), el(sy), CV.fq2_from_numpy(parts(pqx)),
            CV.fq2_from_numpy(parts(pqy)))


@pytest.fixture(scope="module")
def tampered():
    """tests/test_torch_verify.py's batch with signature 2 tampered."""
    msgs = [b"tv-%d" % i for i in range(B)]
    sks = [1000 + 7 * i for i in range(B)]
    hpts = [hash_to_g1(m) for m in msgs]
    sigs = [HC.g1_mul(h, k) for h, k in zip(hpts, sks)]
    sigs[2] = HC.g1_mul(sigs[2], 3)
    pks = [HC.g2_mul(HC.G2_ONE, k) for k in sks]
    return (*JCV.g1_batch_to_device_affine(hpts),
            *JCV.g1_batch_to_device_affine(sigs),
            *JCV.g2_batch_to_device_affine(pks))


@pytest.mark.isolated
def test_independent_tier_matches_jax(tampered):
    want = np.asarray(JBV.verify_batch_independent_staged(*tampered))
    got = BV.verify_batch_independent(*to_port(*tampered)).numpy()
    assert want.tolist() == EXPECTED
    assert got.tolist() == want.tolist()
