"""Vectorised SHA-256 on torch tensors (batched).

Counterpart of `bn254_tpu/hash/sha256.py`, used by the batched
hash-to-G1 path: B messages x K counter candidates in one tensor program.
Words are uint32 values held in int64 tensors; SHA-256's arithmetic is
mod 2^32, so every add is masked with 0xFFFFFFFF, and every rotate and
shift sees a value below 2^32.

Supports fixed-length inputs that fit a whole number of 64-byte blocks
after padding (the batch pipeline pads messages on the host).
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import LIMB_BITS, NLIMBS

_K = (
    0x428A2F98, 0x71374491, 0xB5C0FBCF, 0xE9B5DBA5, 0x3956C25B, 0x59F111F1,
    0x923F82A4, 0xAB1C5ED5, 0xD807AA98, 0x12835B01, 0x243185BE, 0x550C7DC3,
    0x72BE5D74, 0x80DEB1FE, 0x9BDC06A7, 0xC19BF174, 0xE49B69C1, 0xEFBE4786,
    0x0FC19DC6, 0x240CA1CC, 0x2DE92C6F, 0x4A7484AA, 0x5CB0A9DC, 0x76F988DA,
    0x983E5152, 0xA831C66D, 0xB00327C8, 0xBF597FC7, 0xC6E00BF3, 0xD5A79147,
    0x06CA6351, 0x14292967, 0x27B70A85, 0x2E1B2138, 0x4D2C6DFC, 0x53380D13,
    0x650A7354, 0x766A0ABB, 0x81C2C92E, 0x92722C85, 0xA2BFE8A1, 0xA81A664B,
    0xC24B8B70, 0xC76C51A3, 0xD192E819, 0xD6990624, 0xF40E3585, 0x106AA070,
    0x19A4C116, 0x1E376C08, 0x2748774C, 0x34B0BCB5, 0x391C0CB3, 0x4ED8AA4A,
    0x5B9CCA4F, 0x682E6FF3, 0x748F82EE, 0x78A5636F, 0x84C87814, 0x8CC70208,
    0x90BEFFFA, 0xA4506CEB, 0xBEF9A3F7, 0xC67178F2,
)

_H0 = (
    0x6A09E667, 0xBB67AE85, 0x3C6EF372, 0xA54FF53A,
    0x510E527F, 0x9B05688C, 0x1F83D9AB, 0x5BE0CD19,
)

M32 = 0xFFFFFFFF


def _rotr(x, n):
    return ((x >> n) | (x << (32 - n))) & M32


def sha256_blocks(blocks: torch.Tensor) -> torch.Tensor:
    """SHA-256 over pre-padded message blocks.

    blocks: (*batch, nblocks, 16) int64 tensor of big-endian uint32 words
    (padding already applied). Returns the digest as (*batch, 8) words.
    """
    nblocks = blocks.shape[-2]
    batch = tuple(blocks.shape[:-2])
    state = [torch.full(batch, h, dtype=torch.int64, device=blocks.device)
             for h in _H0]

    for blk in range(nblocks):
        w = [blocks[..., blk, t] for t in range(16)]
        for t in range(16, 64):
            x, y = w[t - 15], w[t - 2]
            s0 = _rotr(x, 7) ^ _rotr(x, 18) ^ (x >> 3)
            s1 = _rotr(y, 17) ^ _rotr(y, 19) ^ (y >> 10)
            w.append((w[t - 16] + s0 + w[t - 7] + s1) & M32)

        a, b, c, d, e, f, g, h = state
        for t in range(64):
            S1 = _rotr(e, 6) ^ _rotr(e, 11) ^ _rotr(e, 25)
            ch = (e & f) ^ (~e & g)
            temp1 = (h + S1 + ch + _K[t] + w[t]) & M32
            S0 = _rotr(a, 2) ^ _rotr(a, 13) ^ _rotr(a, 22)
            maj = (a & b) ^ (a & c) ^ (b & c)
            temp2 = S0 + maj
            h, g, f, e, d, c, b, a = (
                g, f, e, (d + temp1) & M32, c, b, a, (temp1 + temp2) & M32
            )
        state = [(s + v) & M32 for s, v in zip(state, (a, b, c, d, e, f, g, h))]
    return torch.stack(state, dim=-1)


def pad_messages_host(messages: list[bytes]) -> np.ndarray:
    """Standard SHA-256 padding of equal-length messages -> blocks array
    (B, nblocks, 16) uint32 BE words (host-side, numpy)."""
    n = len(messages)
    mlen = len(messages[0])
    assert all(len(m) == mlen for m in messages), "equal lengths required"
    total = mlen + 1 + 8
    nblocks = (total + 63) // 64
    buf = np.zeros((n, nblocks * 64), dtype=np.uint8)
    for i, m in enumerate(messages):
        buf[i, :mlen] = np.frombuffer(bytes(m), dtype=np.uint8)
        buf[i, mlen] = 0x80
    bitlen = np.uint64(mlen * 8)
    be = np.frombuffer(bitlen.byteswap().tobytes(), dtype=np.uint8)
    buf[:, -8:] = be
    words = buf.reshape(n, nblocks, 16, 4)
    out = (
        words[..., 0].astype(np.uint32) << 24
        | words[..., 1].astype(np.uint32) << 16
        | words[..., 2].astype(np.uint32) << 8
        | words[..., 3].astype(np.uint32)
    )
    return out


def digest_words_to_limbs(digest: torch.Tensor):
    """(*batch, 8) BE digest words -> limbs.El of the 256-bit value.

    Limb i holds value bits [15i, 15i+15), sourced from the little-endian
    word view (words_le[j] = digest[..., 7-j] holds bits [32j, 32j+32)).
    """
    from ..fields import limbs as L

    mask = (1 << LIMB_BITS) - 1
    limbs = []
    for i in range(NLIMBS):
        lo_bit = LIMB_BITS * i
        j0, off = lo_bit // 32, lo_bit % 32
        if j0 >= 8:
            limbs.append(torch.zeros_like(digest[..., 0]))
            continue
        piece = digest[..., 7 - j0] >> off
        if off + LIMB_BITS > 32 and j0 + 1 < 8:
            piece = piece | (digest[..., 7 - (j0 + 1)] << (32 - off))
        limbs.append(piece & mask)
    return L.El(torch.stack(limbs, dim=0), 1 << 256, 1 << LIMB_BITS)
