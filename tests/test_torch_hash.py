"""The port's batched SHA-256 and hash-to-G1 vs hashlib, the JAX package
and the host search.

`hash_to_g1_batch` at B = 4, K = 8 is held limb for limb against JAX,
with one message whose first valid counter is >= 8, so the device search
misses it and `hash_to_g1_device` must take the host fallback.
"""

import hashlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from bn254_tpu.hash import sha256 as JSHA
from bn254_tpu.hash import tai_batch as JTB
from bn254_tpu.hash.tai import hash_to_g1_affine, hash_to_g1_with_ctr
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.hash import sha256 as SHA
from bn254_tpu_torch.hash import tai_batch as TB

K = 8


def assert_same(j, p):
    assert (p.vmax, p.lmax) == (j.vmax, j.lmax)
    assert np.array_equal(np.asarray(j.arr).astype(np.int64), p.arr.numpy())


@pytest.fixture(scope="module")
def messages():
    """Four 8-byte messages, the last one missed by a K=8 search."""
    cands = [b"tai-%04d" % i for i in range(10000)]
    hits = [m for m in cands[:8] if hash_to_g1_with_ctr(m)[1] < K][:3]
    miss = next(m for m in cands if hash_to_g1_with_ctr(m)[1] >= K)
    return hits + [miss]


@pytest.mark.parametrize("length", [0, 7, 55, 56, 100])
def test_sha256_matches_hashlib_and_jax(length):
    rng = np.random.default_rng(length)
    msgs = [rng.bytes(length) for _ in range(3)]
    blocks = SHA.pad_messages_host(msgs)
    got = SHA.sha256_blocks(torch.from_numpy(blocks.astype(np.int64)))
    want = JSHA.sha256_blocks(jnp.asarray(blocks))
    assert np.array_equal(np.asarray(want).astype(np.int64), got.numpy())
    for i, m in enumerate(msgs):
        dig = b"".join(int(w).to_bytes(4, "big") for w in got[i].tolist())
        assert dig == hashlib.sha256(m).digest()
    assert_same(JSHA.digest_words_to_limbs(want),
                SHA.digest_words_to_limbs(got))


def test_hash_to_g1_batch_matches_jax(messages):
    blocks, w, s = TB.prepare_blocks_host(messages)
    jx, jy, jfound, jfirst = JTB.hash_to_g1_batch(jnp.asarray(blocks), w, s, K)
    px, py, pfound, pfirst = TB.hash_to_g1_batch(
        torch.from_numpy(blocks.astype(np.int64)), w, s, K)
    assert_same(jx, px)
    assert_same(jy, py)
    assert pfound.tolist() == np.asarray(jfound).tolist() == [True] * 3 + [False]
    assert pfirst.tolist() == np.asarray(jfirst).tolist()
    ctrs = [hash_to_g1_with_ctr(m)[1] for m in messages[:3]]
    assert pfirst.tolist()[:3] == ctrs


def test_hash_to_g1_device_fallback(messages):
    jx, jy = JTB.hash_to_g1_device(messages, K)
    px, py = TB.hash_to_g1_device(messages, K)
    assert_same(jx, px)
    assert_same(jy, py)
    xs, ys = L.to_ints(L.from_mont(px)), L.to_ints(L.from_mont(py))
    assert [(int(a), int(b)) for a, b in zip(xs, ys)] == [
        hash_to_g1_affine(m) for m in messages]


def test_hash_to_g1_device_mixed_lengths():
    msgs = [b"sample", b"a longer message", b"helloo", b"x"]
    px, py = TB.hash_to_g1_device(msgs, K)
    xs, ys = L.to_ints(L.from_mont(px)), L.to_ints(L.from_mont(py))
    assert [(int(a), int(b)) for a, b in zip(xs, ys)] == [
        hash_to_g1_affine(m) for m in msgs]
