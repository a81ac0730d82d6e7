"""The port's chunked fused check (`dist/batch_verify.py:
verify_batch_fused_chunked`, BASELINE config 5) off the card.

B = 4 tuples in 2 chunks of 2 with 32-bit GLV weights run through the
card's composition, `fused_op`'s CUDA path with the g++ build of
`fused.cu` standing in for the card (the `host_card` fixture of
tests/test_torch_fused_host.py): the chunked check gives the unchunked
`verify_batch_fused`'s answer on the valid batch and with a signature of
the second chunk tampered (that check is held against the JAX package in
tests/test_torch_verify.py), with each chunk's points and Miller stages,
one fold and one final exponentiation counted launch by launch against
the table chip_smoke.py asserts on the card (`chunked_launches`). A chunk
that does not divide the batch raises; the fold is limb for limb the JAX
package's `_chunk_combine_jit`.
"""

import numpy as np
import pytest

import chip_smoke

from bn254_tpu_torch.curve import glv as GLV
from bn254_tpu_torch.dist import batch_verify as BV
from bn254_tpu_torch.errors import InvalidLengthError
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.hash.tai import hash_to_g1
from bn254_tpu_torch.host import curve as HC
from bn254_tpu_torch.utils import convert as CV
from bn254_tpu_torch.utils import samples as SM
from test_torch_fused_host import host_card, host_lib  # noqa: F401

B, CHUNK, BITS = 4, 2, 32
PAIRS = [(1, 0), (0x5A17, 0xC3), (0x01, 0xFFFF), (0xE7E7, 0x7777)]


def tuples(tamper=None):
    """(hx, hy, sx, sy, pqx, pqy) of B valid tuples, the signature at index
    `tamper` doubled."""
    msgs = [b"chunked-%d" % i for i in range(B)]
    sks = [4000 + 13 * i for i in range(B)]
    hpts = [hash_to_g1(m) for m in msgs]
    sigs = [HC.g1_mul(h, k) for h, k in zip(hpts, sks)]
    if tamper is not None:
        sigs[tamper] = HC.g1_mul(sigs[tamper], 2)
    return (*CV.g1_batch_to_device_affine(hpts),
            *CV.g1_batch_to_device_affine(sigs),
            *CV.g2_batch_to_device_affine(
                [HC.g2_mul(HC.G2_ONE, k) for k in sks]))


def launches(chunks, rows):
    """Fused launches of the check in `chunks` chunks of `rows` tuples:
    chip_smoke.py's table (which it asserts on the card for 128-bit
    weights) with this test's 16-step GLV ladder a chunk."""
    return {k: v for k, v in {
        **chip_smoke.chunked_launches(chunks, rows),
        "glv_dbl_add": chunks * BITS // 2}.items() if v}


@pytest.mark.parametrize("tamper", [None, 3], ids=["valid", "tampered"])
def test_chunked_agrees_with_unchunked(host_card, tamper):
    w = GLV.glv_weights_to_device(PAIRS, BITS)
    args = tuples(tamper)
    whole = bool(BV.verify_batch_fused(*args, w))
    assert host_card(**launches(1, B))
    chunked = bool(BV.verify_batch_fused_chunked(*args, w, chunk=CHUNK))
    assert host_card(**launches(B // CHUNK, CHUNK))
    assert chunked == whole == (tamper is None)


@pytest.mark.parametrize("chunk", [5, 3, 0])
def test_chunk_must_divide_the_batch(chunk):
    w = GLV.glv_weights_to_device(PAIRS, BITS)
    with pytest.raises(InvalidLengthError):
        BV.verify_batch_fused_chunked(*tuples(), w, chunk=chunk)


def test_chunk_combine_matches_jax():
    """The fold on two Fq12 batches at the pins (boundary lanes first),
    limb for limb and bound for bound against JAX's `_chunk_combine_jit`."""
    import jax.numpy as jnp

    from bn254_tpu.dist import batch_verify as JBV
    from bn254_tpu.fields import limbs as JL
    from bn254_tpu.fields import tower as JT

    pins = (L.STD_BOUND, 1 << 16)
    rng = np.random.default_rng(12)
    a, b = ([SM.bounded_limbs(rng, *pins, 5) for _ in range(12)]
            for _ in range(2))

    def jax_fq12(xs):
        els = iter([JL.El(jnp.asarray(x.astype(np.uint32)), *pins)
                    for x in xs])
        return JT.Fq12(*[JT.Fq6(*[JT.Fq2(next(els), next(els))
                                  for _ in range(3)]) for _ in range(2)])

    def port_fq12(xs):
        return CV.fq12_from_numpy([(x, *pins) for x in xs])

    want = JBV._chunk_combine_jit(jax_fq12(a), jax_fq12(b))
    got = BV._chunk_combine(port_fq12(a), port_fq12(b))
    for j, p in zip([e for six in want for pair in six for e in pair],
                    L.tree_leaves(got)):
        assert (p.vmax, p.lmax) == (j.vmax, j.lmax)
        assert np.array_equal(np.asarray(j.arr).astype(np.int64),
                              p.arr.numpy())
