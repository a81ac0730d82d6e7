"""SHA-256 try-and-increment hash-to-G1 (host search path).

Bit-exact replication of the reference algorithm
(reference src/hash.rs:29-63, spec'd in SURVEY.md §3.5):

  v = message || [0x00]
  for ctr in 0..=254:
      v[-1] = ctr
      attempted = BE(SHA256(v))                  # 256-bit int
      if attempted >= 5p: continue               # rejection => uniform
      m = attempted; while m > p: m -= p         # NB strict '>': m == p stays
      try decompress 0x02 || BE(m) as G1         # even-y point
      on success: return that point
  raise HashToPointError

Quirk preserved: the reference's `mod_u256` loop condition is `>` not `>=`
(reference src/utils.rs:32), so a value exactly equal to p is NOT
reduced and then fails Fq decoding downstream — the ctr is skipped rather
than mapped to x = 0.

The batched device path (hash/tai_batch.py) computes the same function for
whole tensors of messages; this module is the scalar host path and the
semantic reference.
"""

from __future__ import annotations

import hashlib

from ..constants import LAST_MULTIPLE_OF_P_BELOW_2_256, P
from ..errors import HashToPointError
from ..host import curve as C
from ..host import field as F


def hash_to_g1_affine(message: bytes):
    """Map bytes to an affine G1 point (x, y) with even y, or raise."""
    v = bytearray(bytes(message) + b"\x00")
    for ctr in range(255):
        v[-1] = ctr
        attempted = int.from_bytes(hashlib.sha256(v).digest(), "big")
        if attempted >= LAST_MULTIPLE_OF_P_BELOW_2_256:
            continue
        m = attempted
        while m > P:
            m -= P
        if m >= P:  # m == P: not a valid Fq element (see module docstring)
            continue
        x = m
        y2 = (x * x * x + 3) % P
        y = F.fq_sqrt(y2)
        if y is None:
            continue
        if y & 1:
            y = P - y  # sign byte 0x02 selects the even-y root
        return (x, y)
    raise HashToPointError("no valid point found in 255 attempts")


def hash_to_g1(message: bytes):
    """Map bytes to a Jacobian G1 point."""
    return C.g1_from_affine(hash_to_g1_affine(message))


def hash_to_g1_with_ctr(message: bytes):
    """Like hash_to_g1_affine but also returns the successful counter value
    (used to cross-check the batched masked-candidate device search)."""
    v = bytearray(bytes(message) + b"\x00")
    for ctr in range(255):
        v[-1] = ctr
        attempted = int.from_bytes(hashlib.sha256(v).digest(), "big")
        if attempted >= LAST_MULTIPLE_OF_P_BELOW_2_256:
            continue
        m = attempted
        while m > P:
            m -= P
        if m >= P:
            continue
        y2 = (m * m * m + 3) % P
        y = F.fq_sqrt(y2)
        if y is None:
            continue
        if y & 1:
            y = P - y
        return (m, y), ctr
    raise HashToPointError("no valid point found in 255 attempts")
