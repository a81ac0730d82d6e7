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
package's `_chunk_combine_jit`. Each chunk's signature tree-sum
(`_g1_tree_sum`), one `g1_add` launch a level on the card, gives the JAX
package's sum by value over 1 to 64 rows with the complete addition's edges
among them, and on the CPU its limbs.
"""

import numpy as np
import pytest

import chip_smoke

from bn254_tpu_torch.curve import g1 as DG1
from bn254_tpu_torch.curve import glv as GLV
from bn254_tpu_torch.curve import jacobian as J
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


def tree_rows(n):
    """n host Jacobian G1 points, [3 + i]G with Z = i + 2, whose first level
    meets the complete addition's edges: row 0 the identity (paired with
    row n // 2), row n // 2 + 1 row 1 in another representation (a
    doubling), row n // 2 + 2 the negation of row 2 (the identity)."""
    pts = [HC.g1_mul(HC.G1_ONE, 3 + i) for i in range(n)]
    rows = []
    for i, (x, y, z) in enumerate(pts):
        lam = i + 2
        rows.append((x * lam ** 2 % HC.P, y * lam ** 3 % HC.P, z * lam % HC.P))
    half = n // 2
    if n >= 2:
        rows[0] = (1, 1, 0)
    if half >= 2:
        x, y, z = rows[1]
        rows[half + 1] = (x * 49 % HC.P, y * 343 % HC.P, z * 7 % HC.P)
    if half >= 3:
        rows[half + 2] = HC.g1_neg(rows[2])
    return rows


def jax_tree_sum(p):
    """The JAX package's `_g1_tree_sum` on the same limbs and bounds, its
    result carried back as port Els."""
    import jax.numpy as jnp

    from bn254_tpu.curve import jacobian as JJ
    from bn254_tpu.dist import batch_verify as JBV
    from bn254_tpu.fields import limbs as JL

    out = JBV._g1_tree_sum(JJ.JPoint(*[
        JL.El(jnp.asarray(e.arr.numpy().astype(np.uint32)), e.vmax, e.lmax)
        for e in p]))
    return J.JPoint(*[CV.from_numpy(np.asarray(e.arr).astype(np.int64),
                                    e.vmax, e.lmax) for e in out])


def host_point(p):
    """A scalar Jacobian point's Montgomery limbs -> host ints."""
    return tuple(int(L.to_ints(L.from_mont(e))) for e in p)


@pytest.mark.parametrize("n", [1, 2, 7, 13, 64])
def test_tree_sum_through_the_card_route(host_card, n):
    """`_g1_tree_sum` on the card's route, one g1_add launch a level, by
    value against the JAX package's tree-sum and the host oracle."""
    rows = tree_rows(n)
    p = DG1.from_host(rows)
    got = BV._g1_tree_sum(p)
    levels = chip_smoke.tree_launches(n)
    assert host_card(**({"g1_add": levels} if levels else {}))
    want = host_point(jax_tree_sum(p))
    assert HC.g1_eq(host_point(got), want)
    total = rows[0]
    for r in rows[1:]:
        total = HC.g1_add(total, r)
    assert HC.g1_eq(want, total)


def test_tree_sum_on_the_cpu_is_jax_limb_for_limb():
    """The CPU route over 13 rows (odd widths carry a row) keeps the JAX
    package's limbs and bounds."""
    p = DG1.from_host(tree_rows(13))
    got, want = BV._g1_tree_sum(p), jax_tree_sum(p)
    for g, w in zip(got, want):
        assert (g.vmax, g.lmax) == (w.vmax, w.lmax)
        assert np.array_equal(w.arr.numpy(), g.arr.numpy())
