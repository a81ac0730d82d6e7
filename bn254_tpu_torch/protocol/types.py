"""Key and signature types with reference-API parity.

Mirrors reference src/types.rs:
  * PrivateKey    — Fr scalar        (types.rs:13-77)
  * PublicKey     — point in G2      (types.rs:81-148)
  * PublicKeyG1   — point in G1      (types.rs:151-218)
  * Signature     — point in G1      (types.rs:222-286)

Aggregation is `+` / `-` / unary `-` on PublicKey / PublicKeyG1 / Signature,
exactly as the reference overloads the Rust operators (types.rs:126-148,
196-218, 264-286).  Points are stored as host Jacobian integer tuples; the
batched device pipeline (`api`) converts at the tensor boundary via
`utils/convert.py`.
"""

from __future__ import annotations

import secrets

from ..constants import R
from ..codec import points as PC
from ..errors import HexDecodeFailedError, InvalidLengthError
from ..host import curve as C


class PrivateKey:
    """Private key: an element of the scalar field Fr (types.rs:13-77)."""

    __slots__ = ("scalar",)

    def __init__(self, scalar: int):
        self.scalar = scalar % R

    # -- constructors -------------------------------------------------------

    @classmethod
    def random(cls, rng=None) -> "PrivateKey":
        """Uniformly random key (rejection sampling over 256-bit strings,
        matching Fr::random semantics at types.rs:17-25)."""
        randbits = rng if rng is not None else (lambda: secrets.randbits(256))
        while True:
            v = randbits()
            if v < R:
                return cls(v)

    @classmethod
    def from_bytes(cls, data: bytes) -> "PrivateKey":
        """32 BE bytes -> Fr, reducing mod r.

        Reduction (not rejection) matches the reference: its example keys
        (examples/bn254.rs:7-12) exceed r, yet Fr::from_slice accepts them —
        so the dependency reduces out-of-range scalars.  Only the length is
        validated (types_test.rs:30-46 expects InvalidLength)."""
        if len(data) != 32:
            raise InvalidLengthError("private key must be 32 bytes")
        return cls(int.from_bytes(data, "big"))

    @classmethod
    def from_hex(cls, hex_str: str) -> "PrivateKey":
        try:
            data = bytes.fromhex(hex_str)
        except ValueError as exc:
            raise HexDecodeFailedError(str(exc)) from exc
        return cls.from_bytes(data)

    # -- serialisation ------------------------------------------------------

    def to_bytes(self) -> bytes:
        """Canonical 32-byte big-endian encoding (utils.rs:66-72)."""
        return self.scalar.to_bytes(32, "big")

    def to_hex(self) -> str:
        return self.to_bytes().hex()

    # -- dunder -------------------------------------------------------------

    def __eq__(self, other) -> bool:
        return isinstance(other, PrivateKey) and self.scalar == other.scalar

    def __hash__(self) -> int:
        return hash(("PrivateKey", self.scalar))

    def __repr__(self) -> str:
        return "PrivateKey(****)"


class _G2Point:
    """Shared behaviour for G2-valued types."""

    __slots__ = ("point",)
    _CHECK_SUBGROUP = True

    def __init__(self, point):
        self.point = point

    @classmethod
    def from_compressed(cls, data: bytes):
        return cls(PC.g2_from_compressed(bytes(data), cls._CHECK_SUBGROUP))

    @classmethod
    def from_uncompressed(cls, data: bytes):
        return cls(PC.g2_from_uncompressed(bytes(data), cls._CHECK_SUBGROUP))

    def to_compressed(self) -> bytes:
        return PC.g2_to_compressed(self.point)

    def to_uncompressed(self) -> bytes:
        return PC.g2_to_uncompressed(self.point)

    def __add__(self, other):
        return type(self)(C.g2_add(self.point, other.point))

    def __sub__(self, other):
        return type(self)(C.g2_add(self.point, C.g2_neg(other.point)))

    def __neg__(self):
        return type(self)(C.g2_neg(self.point))

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and C.g2_eq(self.point, other.point)

    def __hash__(self) -> int:
        return hash((type(self).__name__, C.g2_to_affine(self.point)))


class PublicKey(_G2Point):
    """Public key: a point in G2 (types.rs:81-148)."""

    @classmethod
    def from_private_key(cls, private_key: PrivateKey) -> "PublicKey":
        """pk = G2::one() * sk (types.rs:85-87)."""
        return cls(C.g2_mul(C.G2_ONE, private_key.scalar))

    def __repr__(self) -> str:
        return f"PublicKey({self.to_compressed().hex()})"


class _G1Point:
    """Shared behaviour for G1-valued types."""

    __slots__ = ("point",)

    def __init__(self, point):
        self.point = point

    @classmethod
    def from_compressed(cls, data: bytes):
        return cls(PC.g1_from_compressed(bytes(data)))

    @classmethod
    def from_uncompressed(cls, data: bytes):
        return cls(PC.g1_from_uncompressed(bytes(data)))

    def to_compressed(self) -> bytes:
        return PC.g1_to_compressed(self.point)

    def to_uncompressed(self) -> bytes:
        return PC.g1_to_uncompressed(self.point)

    def __add__(self, other):
        return type(self)(C.g1_add(self.point, other.point))

    def __sub__(self, other):
        return type(self)(C.g1_add(self.point, C.g1_neg(other.point)))

    def __neg__(self):
        return type(self)(C.g1_neg(self.point))

    def __eq__(self, other) -> bool:
        return type(self) is type(other) and C.g1_eq(self.point, other.point)

    def __hash__(self) -> int:
        return hash((type(self).__name__, C.g1_to_affine(self.point)))


class PublicKeyG1(_G1Point):
    """Public key as a point in G1 (types.rs:151-218); used together with the
    G2 public key for the consistency check `check_public_keys`."""

    @classmethod
    def from_private_key(cls, private_key: PrivateKey) -> "PublicKeyG1":
        """pk1 = G1::one() * sk (types.rs:155-157)."""
        return cls(C.g1_mul(C.G1_ONE, private_key.scalar))

    def __repr__(self) -> str:
        return f"PublicKeyG1({self.to_compressed().hex()})"


class Signature(_G1Point):
    """Signature: a point in G1 (types.rs:222-286)."""

    def __repr__(self) -> str:
        return f"Signature({self.to_compressed().hex()})"
