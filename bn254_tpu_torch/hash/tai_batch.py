"""Batched (device) SHA-256 try-and-increment hash-to-G1.

Counterpart of `bn254_tpu/hash/tai_batch.py`: for each message compute K
counter candidates in parallel, validate each (rejection bound, field
membership, quadratic residuosity), then select the FIRST valid counter —
branch-free and bit-exact with the sequential host search (hash/tai.py),
including its strict-`>` reduction edge (a hash that reduces to exactly p
canonicalises to x = 0 here, and x = 0 fails the QR check since 3 is a
non-residue mod p — the same skip).

With success probability ~1/2 per counter, K = 8 leaves ~0.4% of messages
unresolved; `hash_to_g1_device` hashes those on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from .. import obs
from ..constants import B as CURVE_B
from ..constants import LAST_MULTIPLE_OF_P_BELOW_2_256, P
from ..fields import limbs as L
from . import sha256 as SHA

# messages the device search missed and the host hashed, in this process;
# readers take differences
host_fallbacks = 0


def prepare_blocks_host(messages: list[bytes]):
    """Host prep: messages (equal length) -> (blocks, ctr_word, ctr_shift).

    Appends the 0x00 counter byte before SHA padding and reports where the
    counter byte lives in the word grid.
    """
    mlen = len(messages[0])
    assert all(len(m) == mlen for m in messages), "equal lengths required"
    padded = [bytes(m) + b"\x00" for m in messages]
    blocks = SHA.pad_messages_host(padded)
    pos = mlen  # byte index of the ctr within the padded message
    word_flat = pos // 4  # flat word index across blocks
    shift = (3 - pos % 4) * 8  # big-endian byte within the word
    return blocks, word_flat, shift


def hash_to_g1_batch(blocks: torch.Tensor, ctr_word: int, ctr_shift: int,
                     k_candidates: int = 8):
    """Device search over K counters.

    blocks: (B, nblocks, 16) int64 words from `prepare_blocks_host` (ctr 0).
    Returns (x_mont, y_mont, found, ctr): Montgomery affine G1 coords
    (limbs.El of shape (18, B)), a (B,) bool mask, (B,) int64 counters.
    """
    Bn, nblocks, _ = blocks.shape
    nb_word = ctr_word // 16
    w_in_block = ctr_word % 16

    # (B, K, nblocks, 16): add ctr << shift to the counter word
    ctrs = torch.arange(k_candidates, dtype=torch.int64, device=blocks.device)
    bump = blocks.new_zeros((k_candidates, nblocks, 16))
    bump[:, nb_word, w_in_block] = ctrs << ctr_shift
    blocks_k = blocks[:, None] + bump[None]

    digests = SHA.sha256_blocks(blocks_k)  # (B, K, 8)
    attempted = SHA.digest_words_to_limbs(digests)  # El (18, B, K)

    accept = L.lt_const(attempted, LAST_MULTIPLE_OF_P_BELOW_2_256)

    # reduce mod p: attempted < 2^256 < 8p
    x = attempted
    for m in (4 * P, 2 * P, P):
        x = L.cond_sub(x, m)
    x_mont = L.to_mont(x)

    # y^2 = x^3 + 3; sqrt candidate via x^((p+1)/4)
    y2 = L.add_mod(
        L.mont_mul(L.mont_sqr(x_mont), x_mont),
        L.mul_small(L.mont_one(x_mont.batch_shape, x_mont.device), CURVE_B),
    )
    s = L.sqrt_candidate(y2)
    is_qr = L.eq(L.mont_sqr(s), y2)
    valid = accept & is_qr  # (B, K)

    # even-y selection (sign byte 0x02)
    s_canon = L.from_mont(s)
    odd = (s_canon.arr[0] & 1) != 0
    y_mont = L.select(odd, L.neg_mod(s), s)

    # first valid counter per message (argmax returns the first maximum)
    found = valid.any(dim=-1)  # (B,)
    first = torch.argmax(valid.to(torch.int32), dim=-1)  # (B,)
    idx = first[None, :, None].expand(x_mont.arr.shape[0], Bn, 1)
    x_sel = L.elmap(lambda a: torch.gather(a, 2, idx)[:, :, 0], x_mont)
    y_sel = L.elmap(lambda a: torch.gather(a, 2, idx)[:, :, 0], y_mont)
    # The odd-y branch is `neg_mod` of a STD_BOUND-tagged pow output, so
    # the select carries vmax slightly above STD_BOUND — crush it back
    # below the pairing pipeline's carrier bound, post-selection.
    y_sel = L.maybe_vreduce(y_sel, L.STD_BOUND)
    return x_sel, y_sel, found, first


def hash_to_g1_device(messages: list[bytes], k_candidates: int | None = None,
                      device="cpu"):
    """End-to-end batched hash-to-G1 with host fallback for rare misses.

    Returns (x_mont, y_mont) limbs.El of shape (18, B) on `device`,
    bit-exact with the host `hash_to_g1_affine` for every message.
    Mixed-length batches are bucketed per message length (the counter
    position in the SHA word grid differs) and re-stitched in input order.
    """
    from .. import config as C

    if k_candidates is None:
        k_candidates = C.DEFAULT.k_candidates

    with obs.span("hash"):
        lengths = {len(m) for m in messages}
        if len(lengths) <= 1:
            return _hash_one_length(messages, k_candidates, device)
        buckets: dict[int, list[int]] = {}
        for i, m in enumerate(messages):
            buckets.setdefault(len(m), []).append(i)
        xs, ys, order = [], [], []
        for mlen in sorted(buckets):
            idx = buckets[mlen]
            bx, by = _hash_one_length(
                [messages[i] for i in idx], k_candidates, device
            )
            xs.append(bx)
            ys.append(by)
            order.extend(idx)
        inv = np.empty(len(messages), dtype=np.int64)
        inv[np.array(order)] = np.arange(len(messages))
        inv_t = torch.from_numpy(inv).to(device)

        def cat(els):
            return L.El(
                torch.cat([e.arr for e in els], dim=1)[:, inv_t],
                max(e.vmax for e in els),
                max(e.lmax for e in els),
            )

        return cat(xs), cat(ys)


def _hash_one_length(messages: list[bytes], k_candidates: int, device):
    """`hash_to_g1_device` for messages of one length: the device search
    (span `hash.search`), then the host hash of its misses, counted in
    `host_fallbacks` (span `hash.host_fallback`)."""
    global host_fallbacks
    from .tai import hash_to_g1_affine

    with obs.span("hash.search"):
        blocks, w, s = prepare_blocks_host(messages)
        blocks_t = torch.from_numpy(blocks.astype(np.int64)).to(device)
        x, y, found, _ = hash_to_g1_batch(blocks_t, w, s, k_candidates)
        found_np = found.cpu().numpy()
    if found_np.all():
        return x, y
    with obs.span("hash.host_fallback"):
        misses = np.nonzero(~found_np)[0]
        host_fallbacks += len(misses)
        fix = [hash_to_g1_affine(messages[int(i)]) for i in misses]
        fx = L.to_mont(L.from_ints([a[0] for a in fix], vmax=P, device=device))
        fy = L.to_mont(L.from_ints([a[1] for a in fix], vmax=P, device=device))
        midx = torch.from_numpy(misses).to(device)
        xa, ya = x.arr.clone(), y.arr.clone()
        xa[:, midx] = fx.arr
        ya[:, midx] = fy.arr
        return (L.El(xa, max(x.vmax, fx.vmax), x.lmax),
                L.El(ya, max(y.vmax, fy.vmax), y.lmax))
