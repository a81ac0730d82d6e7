"""NEAR alt_bn128_pairing_check input formatters.

Reference parity with reference src/utils.rs:197-239: produce the
Borsh-encoded little-endian `[(G1; 64 B, G2; 128 B); 2]` pairing inputs
  [(H(m), PK), (sig, -G2::one)]
consumed by NEAR's `alt_bn128_pairing_check` host function.
"""

from __future__ import annotations

from ..codec import points as PC
from ..errors import InvalidLengthError
from ..hash.tai import hash_to_g1
from ..host import curve as C
from .types import PublicKey, Signature


def format_pairing_check_values(
    message: bytes, signature: bytes, public_key: bytes
) -> list[tuple[bytes, bytes]]:
    """Compressed-input variant (utils.rs:197-214).

    `signature`: 33-byte compressed G1; `public_key`: 65-byte compressed G2.
    Returns [(64 B G1 LE, 128 B G2 LE); 2].
    """
    msg_hash = hash_to_g1(message)
    msg_hash_le = PC.g1_to_borsh_le(msg_hash)
    pk_point = PublicKey.from_compressed(public_key)
    pk_le = PC.g2_to_borsh_le(pk_point.point)

    sig_point = Signature.from_compressed(signature)
    sig_le = PC.g1_to_borsh_le(sig_point.point)
    neg_g2_le = PC.g2_to_borsh_le(C.g2_neg(C.G2_ONE))

    return [(msg_hash_le, pk_le), (sig_le, neg_g2_le)]


def format_pairing_check_uncompressed_values(
    message: bytes, signature: bytes, public_key: bytes
) -> list[tuple[bytes, bytes]]:
    """Uncompressed-input variant (utils.rs:216-239).

    `signature`: 64-byte BE uncompressed G1; `public_key`: 128-byte BE
    uncompressed G2.  Each 32-byte limb is byte-reversed to little-endian
    in place (no decompression / validation, matching the reference).
    """
    signature = bytes(signature)
    public_key = bytes(public_key)
    if len(signature) != 64:
        raise InvalidLengthError("uncompressed signature must be 64 bytes")
    if len(public_key) != 128:
        raise InvalidLengthError("uncompressed public key must be 128 bytes")

    sig_le = b"".join(
        signature[i : i + 32][::-1] for i in range(0, 64, 32)
    )
    pk_le = b"".join(
        public_key[i : i + 32][::-1] for i in range(0, 128, 32)
    )

    msg_hash = hash_to_g1(message)
    msg_hash_le = PC.g1_to_borsh_le(msg_hash)
    neg_g2_le = PC.g2_to_borsh_le(C.g2_neg(C.G2_ONE))

    return [(msg_hash_le, pk_le), (sig_le, neg_g2_le)]
