"""Point codecs: compressed / uncompressed / borsh-LE encodings of G1 and G2.

Byte-format conventions replicate the reference exactly (SURVEY.md §2.1, §7):
  * G1 compressed, 33 B:  0x02 (y even) / 0x03 (y odd) || x as 32-B BE
    (reference src/utils.rs:84-104)
  * G1 uncompressed, 64 B: x || y, each 32-B BE (utils.rs:182-194)
  * G2 compressed, 65 B:  0x0a / 0x0b || U512(x_im * p + x_re) as 64-B BE,
    sign byte 0x0b iff U512(y) > U512(-y) where U512(c) = c_im * p + c_re
    (utils.rs:130-158)
  * G2 uncompressed, 128 B: x_re || x_im || y_re || y_im, each 32-B BE
    (utils.rs:161-179)
  * Borsh (NEAR precompile input): little-endian affine limbs — G1 64 B
    x_le || y_le, G2 128 B x_re_le || x_im_le || y_re_le || y_im_le
    (utils.rs:204-211, 221-227)

All functions here operate on host-side affine/Jacobian integer points; the
batched device pipeline converts at the tensor boundary.
"""

from __future__ import annotations

from ..constants import P
from ..errors import (
    IndexOutOfBoundsError,
    InvalidEncodingError,
    InvalidGroupPointError,
    InvalidLengthError,
    NotMemberError,
    PointInJacobianError,
)
from ..host import curve as C
from ..host import field as F

# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------


def _fq_from_be(b: bytes) -> int:
    if len(b) != 32:
        raise InvalidLengthError("field element must be 32 bytes")
    v = int.from_bytes(b, "big")
    if v >= P:
        raise NotMemberError("value not a member of Fq")
    return v


def u256_get_bit(value: int, index: int) -> bool:
    """Bit accessor mirroring `arith::U256::get_bit` semantics: the
    reference's compression sign derives y parity through it and maps a
    miss to IndexOutOfBounds (utils.rs:92, error.rs:9-10)."""
    if not 0 <= index < 256:
        raise IndexOutOfBoundsError(f"bit index {index} out of range [0, 256)")
    return bool((value >> index) & 1)


def _u512_of_fq2(c) -> int:
    """U512(c) = c_im * p + c_re — the reference's `to_u512` (utils.rs:40-45)."""
    return (c[1] % P) * P + (c[0] % P)


# ---------------------------------------------------------------------------
# G1
# ---------------------------------------------------------------------------


def g1_to_compressed(pt_jac) -> bytes:
    aff = C.g1_to_affine(pt_jac)
    if aff is None:
        raise PointInJacobianError("cannot serialise the identity point")
    x, y = aff
    sign = b"\x03" if u256_get_bit(y, 0) else b"\x02"
    return sign + x.to_bytes(32, "big")


def g1_from_compressed(data: bytes):
    if len(data) != 33:
        raise InvalidLengthError("compressed G1 must be 33 bytes")
    sign = data[0]
    if sign not in (0x02, 0x03):
        raise InvalidEncodingError("invalid G1 compression sign byte")
    x = _fq_from_be(data[1:])
    y2 = (x * x * x + 3) % P
    y = F.fq_sqrt(y2)
    if y is None:
        raise InvalidGroupPointError("x coordinate not on curve")
    if bool(y & 1) != (sign == 0x03):
        y = P - y
    return C.g1_from_affine((x, y))


def g1_to_uncompressed(pt_jac) -> bytes:
    aff = C.g1_to_affine(pt_jac)
    if aff is None:
        raise PointInJacobianError("cannot serialise the identity point")
    x, y = aff
    return x.to_bytes(32, "big") + y.to_bytes(32, "big")


def g1_from_uncompressed(data: bytes):
    if len(data) != 64:
        raise InvalidLengthError("uncompressed G1 must be 64 bytes")
    x = _fq_from_be(data[0:32])
    y = _fq_from_be(data[32:64])
    if not C.g1_is_on_curve((x, y)):
        raise InvalidGroupPointError("point not on curve")
    return C.g1_from_affine((x, y))


# ---------------------------------------------------------------------------
# G2
# ---------------------------------------------------------------------------


def g2_to_compressed(pt_jac) -> bytes:
    aff = C.g2_to_affine(pt_jac)
    if aff is None:
        raise PointInJacobianError("cannot serialise the identity point")
    x, y = aff
    y_neg = F.fq2_neg(y)
    sign = b"\x0b" if _u512_of_fq2(y) > _u512_of_fq2(y_neg) else b"\x0a"
    return sign + _u512_of_fq2(x).to_bytes(64, "big")


def g2_from_compressed(data: bytes, check_subgroup: bool = True):
    if len(data) != 65:
        raise InvalidLengthError("compressed G2 must be 65 bytes")
    sign = data[0]
    if sign not in (0x0A, 0x0B):
        raise InvalidEncodingError("invalid G2 compression sign byte")
    val = int.from_bytes(data[1:], "big")
    x_im, x_re = divmod(val, P)
    if x_im >= P:
        raise InvalidEncodingError("invalid U512 encoding for G2 x coordinate")
    x = (x_re, x_im)
    y2 = F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), C.B2)
    y = F.fq2_sqrt(y2)
    if y is None:
        raise InvalidGroupPointError("x coordinate not on twist curve")
    y_neg = F.fq2_neg(y)
    want_greater = sign == 0x0B
    if (_u512_of_fq2(y) > _u512_of_fq2(y_neg)) != want_greater:
        y = y_neg
    aff = (x, y)
    if check_subgroup and not C.g2_is_in_subgroup(aff):
        raise InvalidGroupPointError("point not in the r-torsion subgroup")
    return C.g2_from_affine(aff)


def g2_to_uncompressed(pt_jac) -> bytes:
    aff = C.g2_to_affine(pt_jac)
    if aff is None:
        raise PointInJacobianError("cannot serialise the identity point")
    x, y = aff
    return b"".join(
        c.to_bytes(32, "big") for c in (x[0], x[1], y[0], y[1])
    )


def g2_from_uncompressed(data: bytes, check_subgroup: bool = True):
    if len(data) != 128:
        raise InvalidLengthError("uncompressed G2 must be 128 bytes")
    x = (_fq_from_be(data[0:32]), _fq_from_be(data[32:64]))
    y = (_fq_from_be(data[64:96]), _fq_from_be(data[96:128]))
    aff = (x, y)
    if not C.g2_is_on_curve(aff):
        raise InvalidGroupPointError("point not on twist curve")
    if check_subgroup and not C.g2_is_in_subgroup(aff):
        raise InvalidGroupPointError("point not in the r-torsion subgroup")
    return C.g2_from_affine(aff)


# ---------------------------------------------------------------------------
# Borsh little-endian affine encodings (NEAR alt_bn128 precompile format)
# ---------------------------------------------------------------------------


def g1_to_borsh_le(pt_jac) -> bytes:
    aff = C.g1_to_affine(pt_jac)
    if aff is None:
        raise PointInJacobianError("cannot serialise the identity point")
    x, y = aff
    return x.to_bytes(32, "little") + y.to_bytes(32, "little")


def g2_to_borsh_le(pt_jac) -> bytes:
    aff = C.g2_to_affine(pt_jac)
    if aff is None:
        raise PointInJacobianError("cannot serialise the identity point")
    x, y = aff
    return b"".join(
        c.to_bytes(32, "little") for c in (x[0], x[1], y[0], y[1])
    )
