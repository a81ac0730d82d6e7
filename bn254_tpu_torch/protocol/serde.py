"""JSON (de)serialisation of PrivateKey / PublicKey.

Wire-compatible with the reference's serde impls
(reference src/serde.rs:10-56), which serialise both types as JSON
sequences of byte values:
  * PrivateKey  -> [b0, ..., b31]      (32 canonical BE bytes)
  * PublicKey   -> [b0, ..., b64]      (65 compressed bytes)
"""

from __future__ import annotations

import json

from ..errors import SerializationError
from .types import PrivateKey, PublicKey


def _decode_byte_seq(data: str) -> bytes:
    """JSON sequence-of-byte-values -> bytes.

    Malformed wire data maps to SerializationError, the reference's
    catch-all for (de)serialisation failures
    (reference src/error.rs:27-28,64-74)."""
    try:
        seq = json.loads(data)
        return bytes(seq)
    except (json.JSONDecodeError, TypeError, ValueError) as e:
        raise SerializationError(f"invalid serialized byte sequence: {e}")


def private_key_to_json(key: PrivateKey) -> str:
    return json.dumps(list(key.to_bytes()))


def private_key_from_json(data: str) -> PrivateKey:
    return PrivateKey.from_bytes(_decode_byte_seq(data))


def public_key_to_json(key: PublicKey) -> str:
    return json.dumps(list(key.to_compressed()))


def public_key_from_json(data: str) -> PublicKey:
    return PublicKey.from_compressed(_decode_byte_seq(data))
