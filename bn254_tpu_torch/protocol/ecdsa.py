"""BLS sign / verify / key-consistency protocol core.

Reference parity with reference src/ecdsa.rs:
  * ECDSA.sign     — sig = H(m) * sk in G1                 (ecdsa.rs:26-35)
  * ECDSA.verify   — e(H(m), PK) * e(sig, -G2::one) == 1   (ecdsa.rs:49-64)
  * check_public_keys — e(G1::one, PK2) * e(-ish PK1, G2)  (ecdsa.rs:78-93)

(The scheme is BLS despite the reference's "ECDSA" name — see lib.rs:8-9 and
SURVEY.md §0; the class name is kept for API parity.)

These are the single-operation host paths: host/pairing.py's pairing
product and host/curve.py's scalar mul, on the native C++ host core when it
is available (host/native.py), else pure Python. Batched device execution
lives in `api` and `dist/batch_verify.py`.
"""

from __future__ import annotations

from ..errors import VerificationFailedError
from ..hash.tai import hash_to_g1
from ..host import curve as C
from ..host import pairing as PR
from .types import PrivateKey, PublicKey, PublicKeyG1, Signature


class ECDSA:
    """BLS-style signing over BN254 (name kept for reference-API parity)."""

    @staticmethod
    def sign(message: bytes, private_key: PrivateKey) -> Signature:
        """sig = H(m) * sk, H = SHA-256 try-and-increment into G1."""
        hash_point = hash_to_g1(message)
        return Signature(C.g1_mul(hash_point, private_key.scalar))

    @staticmethod
    def verify(message: bytes, signature: Signature, public_key: PublicKey) -> None:
        """Raise VerificationFailedError unless
        e(H(m), PK) * e(sig, -G2::one()) == 1."""
        hash_point = hash_to_g1(message)
        result = PR.pairing_batch(
            [
                (hash_point, public_key.point),
                (signature.point, C.g2_neg(C.G2_ONE)),
            ]
        )
        if not PR.gt_eq(result, PR.GT_ONE):
            raise VerificationFailedError("bn254 verification failed")


def check_public_keys(public_key_g2: PublicKey, public_key_g1: PublicKeyG1) -> None:
    """Consistency check that both keys share one secret:
    e(G1::one, PK2) * e(PK1, -G2::one) == 1."""
    result = PR.pairing_batch(
        [
            (C.G1_ONE, public_key_g2.point),
            (public_key_g1.point, C.g2_neg(C.G2_ONE)),
        ]
    )
    if not PR.gt_eq(result, PR.GT_ONE):
        raise VerificationFailedError("public key consistency check failed")
