"""BN254 (alt_bn128) curve constants.

All values are standard, publicly documented parameters of the alt_bn128 curve
(the curve of the EVM bn256Add/bn256ScalarMul/bn256Pairing precompiles), the
same curve implemented by the reference library (see reference src/lib.rs:4-6
for the curve identification and SURVEY.md §2.3 for the parameter derivation).

The BN parametrisation uses u = 4965661367192848881:
    p(u) = 36u^4 + 36u^3 + 24u^2 + 6u + 1   (base field modulus)
    r(u) = 36u^4 + 36u^3 + 18u^2 + 6u + 1   (group order / scalar field)
    t(u) = 6u^2 + 1                          (trace of Frobenius)
Optimal-ate Miller loop count: 6u + 2.
"""

# BN parameter
U = 4965661367192848881
ATE_LOOP_COUNT = 6 * U + 2  # 29793968203157093288

# Base field modulus p (Fq)
P = 21888242871839275222246405745257275088696311157297823662689037894645226208583
# Scalar field modulus r (Fr)
R = 21888242871839275222246405745257275088548364400416034343698204186575808495617

assert P == 36 * U**4 + 36 * U**3 + 24 * U**2 + 6 * U + 1
assert R == 36 * U**4 + 36 * U**3 + 18 * U**2 + 6 * U + 1

# Curve: E/Fq : y^2 = x^3 + 3, cofactor 1 (reference: hash.rs:19-20)
B = 3

# G1 generator (1, 2) — corroborated by the doubling vector at
# reference src/bn256.json:33-37 and types_test.rs:157.
G1_GEN = (1, 2)

# Fq2 = Fq[i]/(i^2 + 1); the sextic twist uses xi = 9 + i.
# E'/Fq2 : y^2 = x^3 + b', b' = 3 / (9 + i)  (D-type twist)
XI = (9, 1)

# G2 generator (standard alt_bn128 G2 generator; corroborated by the public-key
# derivation vectors at reference src/types_test.rs:72-129).
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# Rejection bound for hash-to-G1: the largest multiple of p below 2^256 (= 5p).
# Matches the constant at reference src/hash.rs:11-14 (proven = 5p by
# hash_test.rs:34-43).
LAST_MULTIPLE_OF_P_BELOW_2_256 = 5 * P
assert LAST_MULTIPLE_OF_P_BELOW_2_256 == int(
    "f1f5883e65f820d099915c908786b9d3f58714d70a38f4c22ca2bc723a70f263", 16
)

# sqrt exponent: p ≡ 3 (mod 4) so sqrt(a) = a^((p+1)/4) when a is a QR.
assert P % 4 == 3
SQRT_EXP_P = (P + 1) // 4

# ---------------------------------------------------------------------------
# Limb layout for the device representation.
#
# Field elements are little-endian 15-bit limbs held in int64 tensors of
# shape (NLIMBS, ...) (uint32 arithmetic inside the CUDA kernel).  The one bit of limb headroom and ~14 bits
# of value headroom (capacity 2^270 vs values < ~2^258) enable lazy
# arithmetic: carry-free adds, offset-based subs, and REDC without
# conditional subtraction. See fields/limbs.py for the full design notes.
# ---------------------------------------------------------------------------
LIMB_BITS = 15
NLIMBS = 18  # 270 bits capacity
LIMB_MASK = (1 << LIMB_BITS) - 1

# Montgomery constants for Fq with radix R = 2^(15*18) = 2^270
MONT_R = 1 << (LIMB_BITS * NLIMBS)
MONT_R_MOD_P = MONT_R % P
MONT_R2_MOD_P = (MONT_R * MONT_R) % P
# -p^{-1} mod 2^256 (for REDC)
MONT_NEG_P_INV = (-pow(P, -1, MONT_R)) % MONT_R

# Same for Fr (host-side mostly, but kept for completeness)
MONT_R_MOD_R = MONT_R % R
MONT_R2_MOD_R = (MONT_R * MONT_R) % R
MONT_NEG_R_INV = (-pow(R, -1, MONT_R)) % MONT_R


def to_limbs(x: int, n: int = NLIMBS, bits: int = LIMB_BITS) -> list[int]:
    """Split a non-negative int into n little-endian limbs of `bits` bits."""
    mask = (1 << bits) - 1
    return [(x >> (bits * i)) & mask for i in range(n)]


def from_limbs(limbs, bits: int = LIMB_BITS) -> int:
    """Recombine little-endian limbs into an int."""
    acc = 0
    for i, limb in enumerate(limbs):
        acc |= int(limb) << (bits * i)
    return acc
