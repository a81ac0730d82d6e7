"""Framework error taxonomy.

Mirrors the reference's 11-variant error enum (reference src/error.rs:5-29)
as a Python exception hierarchy rooted at `Bn254Error`.
"""


class Bn254Error(Exception):
    """Base class for all bn254_tpu_torch errors."""


class HashToPointError(Bn254Error):
    """Failed to find a valid point while converting hash to point."""


class IndexOutOfBoundsError(Bn254Error):
    """Failed to get data from an index out of bounds."""


class InvalidEncodingError(Bn254Error):
    """Failed to create group or field due to invalid input encoding."""


class InvalidGroupPointError(Bn254Error):
    """Failed to map point to the curve (not on curve / not in subgroup)."""


class InvalidLengthError(Bn254Error):
    """Failed to create group or field due to invalid input length."""


class NotMemberError(Bn254Error):
    """Failed to create a field element (value not a member of the field)."""


class ToAffineConversionError(Bn254Error):
    """Failed to convert to affine coordinates."""


class PointInJacobianError(Bn254Error):
    """Point could not be normalised from Jacobian coordinates (identity)."""


class VerificationFailedError(Bn254Error):
    """Bn254 signature / pairing verification failed."""


class SerializationError(Bn254Error):
    """Serialization failed."""


class HexDecodeFailedError(Bn254Error):
    """Hex decoding failed."""
