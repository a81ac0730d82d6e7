"""bn254_tpu_torch — BN254 pairing and BLS aggregate signatures in PyTorch,
with hand-written CUDA kernels for the hot loops.

The PyTorch/CUDA port of `bn254_tpu` (JAX), which stays the reference:
every function here has a JAX twin it is tested against, limb for limb.
This package imports neither JAX nor anything of `bn254_tpu`.

Public API (parity with the reference's src/lib.rs:60-63 and with
`bn254_tpu`'s exports): PrivateKey, PublicKey, PublicKeyG1, Signature,
ECDSA, check_public_keys, format_pairing_check_values,
format_pairing_check_uncompressed_values, Bn254Error and subclasses, and
Config. These run on the host (Python ints).

Device entry points (`api`): `batch_sign`, `batch_verify` and
`batch_check_public_keys` run on the CUDA card unless called with
`device="cpu"`; below them every function follows the device of its input
tensors. The CLI (`python -m bn254_tpu_torch`) wraps both. Importing the
package builds nothing: a kernel is compiled by nvcc at its first use on a
CUDA tensor.
"""

from .config import Config
from .errors import (
    Bn254Error,
    HashToPointError,
    HexDecodeFailedError,
    IndexOutOfBoundsError,
    InvalidEncodingError,
    InvalidGroupPointError,
    InvalidLengthError,
    NotMemberError,
    PointInJacobianError,
    SerializationError,
    ToAffineConversionError,
    VerificationFailedError,
)
from .protocol.ecdsa import ECDSA, check_public_keys
from .protocol.format import (
    format_pairing_check_uncompressed_values,
    format_pairing_check_values,
)
from .protocol.types import PrivateKey, PublicKey, PublicKeyG1, Signature

__version__ = "0.2.0"

__all__ = [
    "Config",
    "ECDSA",
    "check_public_keys",
    "PrivateKey",
    "PublicKey",
    "PublicKeyG1",
    "Signature",
    "format_pairing_check_values",
    "format_pairing_check_uncompressed_values",
    "Bn254Error",
    "HashToPointError",
    "IndexOutOfBoundsError",
    "InvalidEncodingError",
    "InvalidGroupPointError",
    "InvalidLengthError",
    "NotMemberError",
    "ToAffineConversionError",
    "PointInJacobianError",
    "VerificationFailedError",
    "SerializationError",
    "HexDecodeFailedError",
    "__version__",
]
