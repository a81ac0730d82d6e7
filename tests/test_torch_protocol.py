"""The port's protocol layer vs the JAX package's, on the same inputs.

`bn254_tpu_torch.{codec,protocol,host.pairing}` are framework-free copies;
these tests hold them to their twins in `bn254_tpu`: every encoding
(compressed, uncompressed, Borsh LE, JSON) byte for byte on numpy-seeded
G1 and G2 points and on the go-ethereum vectors of tests/data/bn256.json,
the NEAR formatters, ECDSA sign / verify / check_public_keys, each error
path by the class of the same name, the pure-Python pairing product, and
`api.aggregate_*` by compressed bytes. They also mirror the reference
vectors of tests/test_{types,format,serde,ecdsa,errors,host_pairing}.py.
"""

import json
import os

import numpy as np
import pytest

import bn254_tpu
import bn254_tpu_torch
from bn254_tpu import api as japi
from bn254_tpu.codec import points as JPC
from bn254_tpu.host import pairing as JPR
from bn254_tpu.protocol import serde as jserde
from bn254_tpu_torch import api
from bn254_tpu_torch import errors as E
from bn254_tpu_torch.codec import points as PC
from bn254_tpu_torch.constants import P, R
from bn254_tpu_torch.hash.tai import hash_to_g1
from bn254_tpu_torch.host import curve as C
from bn254_tpu_torch.host import field as F
from bn254_tpu_torch.host import native as N
from bn254_tpu_torch.host import pairing as PR
from bn254_tpu_torch.protocol import serde
from bn254_tpu_torch.utils import convert as CV

T, J = bn254_tpu_torch, bn254_tpu

with open(os.path.join(os.path.dirname(__file__), "data", "bn256.json")) as f:
    BN256 = json.load(f)

SK1_HEX = "1ab1126ff2e37c6e6eddea943ccb3a48f83b380b856424ee552e113595525565"
SK2_HEX = "2009da7287c158b126123c113d1c85241b6e3294dd75c643588630a8bc0f934c"
MSG = b"sample"
SIG2_HEX = "020f047a153e94b5f109e4013d1bd078112817cf0d58cdf6ba8891f9849852ba5b"

_rng = np.random.default_rng(1313)
SCALARS = [int.from_bytes(_rng.bytes(32), "big") % R for _ in range(4)]


def g1_point(i):
    return C.g1_mul(C.G1_ONE, SCALARS[i])


def g2_point(i):
    return C.g2_mul(C.G2_ONE, SCALARS[i])


# ---------------------------------------------------------------------------
# codec: every encoding byte-equal, both ways
# ---------------------------------------------------------------------------

G1_CODECS = [("g1_to_compressed", "g1_from_compressed"),
             ("g1_to_uncompressed", "g1_from_uncompressed"),
             ("g1_to_borsh_le", None)]
G2_CODECS = [("g2_to_compressed", "g2_from_compressed"),
             ("g2_to_uncompressed", "g2_from_uncompressed"),
             ("g2_to_borsh_le", None)]


@pytest.mark.parametrize("i", range(4))
@pytest.mark.parametrize("enc,dec", G1_CODECS)
def test_g1_encodings_byte_equal(i, enc, dec):
    pt = g1_point(i)
    data = getattr(PC, enc)(pt)
    assert data == getattr(JPC, enc)(pt)
    if dec:
        assert C.g1_eq(getattr(PC, dec)(data), pt)
        assert C.g1_eq(getattr(JPC, dec)(data), getattr(PC, dec)(data))


@pytest.mark.parametrize("i", range(3))
@pytest.mark.parametrize("enc,dec", G2_CODECS)
def test_g2_encodings_byte_equal(i, enc, dec):
    pt = g2_point(i)
    data = getattr(PC, enc)(pt)
    assert data == getattr(JPC, enc)(pt)
    if dec:
        assert C.g2_eq(getattr(PC, dec)(data), pt)
        assert C.g2_eq(getattr(JPC, dec)(data), getattr(PC, dec)(data))


def test_g2_compression_sign_covers_both_roots():
    """Both sign bytes occur on these points and on their negations, and
    each decodes to the same point in both packages."""
    signs = set()
    for i in range(3):
        for pt in (g2_point(i), C.g2_neg(g2_point(i))):
            data = PC.g2_to_compressed(pt)
            signs.add(data[0])
            assert data == JPC.g2_to_compressed(pt)
            assert C.g2_eq(PC.g2_from_compressed(data), pt)
    assert signs == {0x0A, 0x0B}


def _aff(xh, yh):
    x, y = int(xh, 16), int(yh, 16)
    return None if x == y == 0 else (x, y)


@pytest.mark.parametrize("vec", BN256["add"], ids=range(len(BN256["add"])))
def test_bn256_add_vectors_through_signature_sum(vec):
    """The go-ethereum G1 add vectors as Signature + Signature, encoded by
    both packages."""
    a = T.Signature(C.g1_from_affine(_aff(vec["x1"], vec["y1"])))
    b = T.Signature(C.g1_from_affine(_aff(vec["x2"], vec["y2"])))
    ja = J.Signature(a.point)
    jb = J.Signature(b.point)
    want = _aff(vec["result"][:64], vec["result"][64:])
    s, js = a + b, ja + jb
    if want is None:
        for fn in (s.to_uncompressed, s.to_compressed):
            with pytest.raises(E.PointInJacobianError):
                fn()
        with pytest.raises(J.PointInJacobianError):
            js.to_uncompressed()
        return
    assert s.to_uncompressed().hex() == vec["result"]
    assert s.to_uncompressed() == js.to_uncompressed()
    assert s.to_compressed() == js.to_compressed()


@pytest.mark.parametrize("vec", BN256["mul"][::2], ids=range(9))
def test_bn256_mul_vectors_through_codec(vec):
    pt = C.g1_mul(C.g1_from_affine(_aff(vec["x"], vec["y"])),
                  int(vec["scalar"], 16))
    want = _aff(vec["result"][:64], vec["result"][64:])
    if want is None:
        assert C.g1_to_affine(pt) is None
        return
    data = PC.g1_to_uncompressed(pt)
    assert data.hex() == vec["result"]
    assert PC.g1_to_compressed(pt) == JPC.g1_to_compressed(pt)
    assert PC.g1_to_borsh_le(pt) == JPC.g1_to_borsh_le(pt)


# ---------------------------------------------------------------------------
# types (reference types_test.rs), against bn254_tpu
# ---------------------------------------------------------------------------

DERIVATION_VECTORS = [
    (SK1_HEX,
     "28fe26becbdc0384aa67bf734d08ec78ecc2330f0aa02ad9da00f56c37907f78"
     "2cd080d897822a95a0fb103c54f06e9bf445f82f10fe37efce69ecb59514abc8"
     "237faeb0351a693a45d5d54aa9759f52a71d76edae2132616d6085a9b2228bf9"
     "0f46bd1ef47552c3089604c65a3e7154e3976410be01149b60d5a41a6053e6c2"),
    (SK2_HEX,
     "1cd5df38ed2f184b9830bfd3c2175d53c1455352307ead8cbd7c6201202f4aa8"
     "02ce1c4241143cc61d82589c9439c6dd60f81fa6f029625d58bc0f2e25e4ce89"
     "0ba19ae3b5a298b398b3b9d410c7e48c4c8c63a1d6b95b098289fbe1503d00fb"
     "2ec596e93402de0abc73ce741f37ed4984a0b59c96e20df8c9ea1c4e6ec04556"),
    ("26fb4d661491b0a623637a2c611e34b6641cdea1743bee94c17b67e5ef14a550",
     "077dfcf14e940b69bf88fa1ad99b6c7e1a1d6d2cb8813ac53383bf505a17f8ff"
     "2d1a9b04a2c5674373353b5a25591292e69c37c0b84d9ef1c780a57bb98638e6"
     "2dc52f109b333c4125bccf55bc3a839ce57676514405656c79e577e231519273"
     "2410eee842807d9325f22d087fa6bc79d9bbea07f5fa8c345e1e57b28ad54f84"),
    ("0f6b8785374476a3b3e4bde2c64dfb12964c81c7930d32367c8e318609387872",
     "270567a05b56b02e813281d554f46ce0c1b742b622652ef5a41d69afb6eb8338"
     "1bab5671c5107de67fe06007dde240a84674c8ff13eeac6d64bad0caf2cfe53e"
     "0142f4e04fc1402e17ae7e624fd9bd15f1eae0a1d8eda4e26ab70fd4cd793338"
     "02b54a5deaaf86dc7f03d080c8373d62f03b3be06dac42b2d9426a8ebd0caf4a"),
]


@pytest.mark.parametrize("sk_hex,pk_hex", DERIVATION_VECTORS)
def test_public_key_derivation(sk_hex, pk_hex):
    pk = T.PublicKey.from_private_key(T.PrivateKey.from_hex(sk_hex))
    assert pk.to_uncompressed().hex() == pk_hex
    assert pk == T.PublicKey.from_uncompressed(bytes.fromhex(pk_hex))
    jpk = J.PublicKey.from_private_key(J.PrivateKey.from_hex(sk_hex))
    assert pk.to_compressed() == jpk.to_compressed()
    g1 = T.PublicKeyG1.from_private_key(T.PrivateKey.from_hex(sk_hex))
    assert g1.to_compressed() == J.PublicKeyG1.from_private_key(
        J.PrivateKey.from_hex(sk_hex)).to_compressed()


def test_private_key_vectors():
    raw = bytes.fromhex(
        "023aed31b5a9e486366ea9988b05dba469c6206e58361d9c065bbea7d928204a")
    assert T.PrivateKey.from_bytes(raw).to_bytes() == raw
    assert T.PrivateKey.from_hex(raw.hex()).to_hex() == raw.hex()
    # reduction mod r, as the reference's example keys need
    big = (R + 5).to_bytes(32, "big")
    assert T.PrivateKey.from_bytes(big).to_bytes() == \
        J.PrivateKey.from_bytes(big).to_bytes()
    assert repr(T.PrivateKey(7)) == repr(J.PrivateKey(7)) == "PrivateKey(****)"
    seq = iter([R + 1, R, 12345])
    assert T.PrivateKey.random(lambda: next(seq)).scalar == 12345


def test_public_key_vectors_roundtrip():
    compressed = bytes.fromhex(
        "0a023aed31b5a9e486366ea9988b05dba469c6206e58361d9c065bbea7d928204a"
        "761efc6e4fa08ed227650134b52c7f7dd0463963e8a4bf21f4899fe5da7f984a")
    pk = T.PublicKey.from_compressed(compressed)
    assert pk.to_compressed() == compressed
    assert pk.to_uncompressed() == J.PublicKey.from_compressed(
        compressed).to_uncompressed()
    assert repr(pk) == repr(J.PublicKey.from_compressed(compressed))


def test_aggregate_golden_and_operators():
    """types_test.rs:133-159, then - and unary - against bn254_tpu."""
    agg = T.PublicKey(C.G2_ONE) + T.PublicKey(C.G2_ONE)
    assert agg.to_compressed().hex() == (
        "0b061848379c6bccd9e821e63ff6932738835b78e1e10079a0866073eba5b8bb44"
        "4afbb053d16542e2b839477434966e5a9099093b6b3351f84ac19fe28f096548")
    sig = T.Signature(C.G1_ONE) + T.Signature(C.G1_ONE)
    assert sig.to_compressed().hex() == (
        "02030644e72e131a029b85045b68181585d97816a916871ca8d3c208c16d87cfd3")
    p1, p2 = T.PublicKey(g2_point(0)), T.PublicKey(g2_point(1))
    j1, j2 = J.PublicKey(p1.point), J.PublicKey(p2.point)
    assert (p2 - p1).to_compressed() == (j2 - j1).to_compressed()
    assert (-p1).to_compressed() == (-j1).to_compressed()
    s1, s2 = T.Signature(g1_point(0)), T.Signature(g1_point(1))
    js1, js2 = J.Signature(s1.point), J.Signature(s2.point)
    assert (s2 - s1).to_compressed() == (js2 - js1).to_compressed()
    g = T.PublicKeyG1(g1_point(2))
    assert (-g) + g + g == g
    assert hash(g) == hash(T.PublicKeyG1(g.point))
    assert g != T.Signature(g.point)  # same point, another type


# ---------------------------------------------------------------------------
# ECDSA (reference ecdsa_test.rs), against bn254_tpu
# ---------------------------------------------------------------------------


@pytest.fixture(params=["core", "oracle"])
def host_path(request, monkeypatch):
    """The host math on the native core (the default) or on the
    pure-Python oracle (BN254_DISABLE_NATIVE=1); afterwards the test's calls
    into the core must match the path: some on the core, none on the
    oracle."""
    if request.param == "core":
        if N.compiler() is None:
            pytest.skip("no C++ compiler on PATH")
        monkeypatch.delenv("BN254_DISABLE_NATIVE", raising=False)
    else:
        monkeypatch.setenv("BN254_DISABLE_NATIVE", "1")
    before = sum(N.calls.values())
    yield request.param
    assert (sum(N.calls.values()) > before) == (request.param == "core")


def test_sign_golden_and_verify(host_path):
    sk = T.PrivateKey.from_hex(SK2_HEX)
    sig = T.ECDSA.sign(MSG, sk)
    assert sig.to_compressed().hex() == SIG2_HEX
    T.ECDSA.verify(MSG, T.Signature.from_compressed(bytes.fromhex(SIG2_HEX)),
                   T.PublicKey.from_private_key(sk))
    T.ECDSA.verify(MSG, T.Signature.from_uncompressed(sig.to_uncompressed()),
                   T.PublicKey.from_private_key(sk))


@pytest.mark.parametrize("i", range(3))
def test_sign_equals_jax_on_seeded_messages(i):
    rng = np.random.default_rng(2000 + i)
    msg = rng.bytes(int(rng.integers(0, 80)))
    sk = T.PrivateKey(SCALARS[i])
    sig = T.ECDSA.sign(msg, sk)
    assert sig.to_compressed() == J.ECDSA.sign(
        msg, J.PrivateKey(SCALARS[i])).to_compressed()
    T.ECDSA.verify(msg, sig, T.PublicKey.from_private_key(sk))


def test_verify_rejects_wrong_key_and_message():
    sk1, sk2 = T.PrivateKey.from_hex(SK1_HEX), T.PrivateKey.from_hex(SK2_HEX)
    sig = T.ECDSA.sign(MSG, sk2)
    with pytest.raises(E.VerificationFailedError):
        T.ECDSA.verify(MSG, sig, T.PublicKey.from_private_key(sk1))
    with pytest.raises(E.VerificationFailedError):
        T.ECDSA.verify(b"other message", sig, T.PublicKey.from_private_key(sk2))


def test_verify_aggregate_and_example_flow(host_path):
    """ecdsa_test.rs:42-79 and examples/bn254.rs: the two-key aggregate."""
    sk1 = T.PrivateKey.from_hex(
        "c9afa9d845ba75166b5c215767b1d6934e50c3db36e89b127b8a622b120f6721")
    sk2 = T.PrivateKey.from_hex(
        "a55e93edb1350916bf5beea1b13d8f198ef410033445bcb645b65be5432722f1")
    pk1, pk2 = (T.PublicKey.from_private_key(k) for k in (sk1, sk2))
    sig1, sig2 = T.ECDSA.sign(MSG, sk1), T.ECDSA.sign(MSG, sk2)
    T.ECDSA.verify(MSG, sig1 + sig2, pk1 + pk2)
    with pytest.raises(E.VerificationFailedError):
        T.ECDSA.verify(MSG, sig1 + sig1, pk1 + pk2)


def test_check_public_keys():
    """ecdsa_test.rs:83-131."""
    sk1, sk2 = T.PrivateKey.from_hex(SK1_HEX), T.PrivateKey.from_hex(SK2_HEX)
    pk2 = T.PublicKey.from_private_key(sk1)
    pk1 = T.PublicKeyG1.from_private_key(sk1)
    T.check_public_keys(pk2, pk1)
    T.check_public_keys(pk2, T.PublicKeyG1.from_uncompressed(
        pk1.to_uncompressed()))
    with pytest.raises(E.VerificationFailedError):
        T.check_public_keys(pk2, T.PublicKeyG1.from_private_key(sk2))


# ---------------------------------------------------------------------------
# NEAR formatters and JSON serde, byte-equal to bn254_tpu
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(3))
def test_formatters_byte_equal(i):
    msg = b"near-%d" % i * (i + 1)
    sk = SCALARS[i]
    sig = T.ECDSA.sign(msg, T.PrivateKey(sk))
    pk = T.PublicKey(g2_point(i))
    got = T.format_pairing_check_values(msg, sig.to_compressed(),
                                        pk.to_compressed())
    assert got == J.format_pairing_check_values(msg, sig.to_compressed(),
                                                pk.to_compressed())
    assert got == T.format_pairing_check_uncompressed_values(
        msg, sig.to_uncompressed(), pk.to_uncompressed())
    assert got == J.format_pairing_check_uncompressed_values(
        msg, sig.to_uncompressed(), pk.to_uncompressed())
    (h_le, pk_le), (sig_le, ng2_le) = got
    assert h_le == PC.g1_to_borsh_le(hash_to_g1(msg))
    assert ng2_le == PC.g2_to_borsh_le(C.g2_neg(C.G2_ONE))
    be = sig.to_uncompressed()
    assert sig_le == be[:32][::-1] + be[32:][::-1]


@pytest.mark.parametrize("sig_len,pk_len", [(10, 128), (64, 11)])
def test_uncompressed_formatter_length_checks(sig_len, pk_len):
    with pytest.raises(E.InvalidLengthError):
        T.format_pairing_check_uncompressed_values(
            MSG, b"\x00" * sig_len, b"\x00" * pk_len)


@pytest.mark.parametrize("i", range(3))
def test_serde_byte_equal(i):
    sk = T.PrivateKey(SCALARS[i])
    pk = T.PublicKey(g2_point(i))
    enc = serde.private_key_to_json(sk)
    assert enc == jserde.private_key_to_json(J.PrivateKey(SCALARS[i]))
    assert serde.private_key_from_json(enc) == sk
    penc = serde.public_key_to_json(pk)
    assert penc == jserde.public_key_to_json(J.PublicKey(pk.point))
    assert len(json.loads(penc)) == 65
    assert serde.public_key_from_json(penc) == pk


# ---------------------------------------------------------------------------
# error paths: the port raises its own class of the same name
# ---------------------------------------------------------------------------

def _twist_point_outside_subgroup():
    """A point of E'(Fq2) that is not in G2 (the cofactor is large, so the
    first x with a square root is almost surely outside)."""
    x0 = 1
    while True:
        x = (x0, 1)
        y = F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), C.B2))
        if y is not None and not C.g2_is_in_subgroup((x, y)):
            return b"".join(c.to_bytes(32, "big")
                            for c in (x[0], x[1], y[0], y[1]))
        x0 += 1


ERROR_CASES = {
    "HexDecodeFailedError": lambda m: m.PrivateKey.from_hex("zz"),
    "InvalidLengthError": lambda m: m.Signature.from_compressed(b"\x02" * 5),
    "InvalidEncodingError": lambda m: m.Signature.from_compressed(
        b"\x04" + b"\x00" * 32),
    "InvalidEncodingError-g2": lambda m: m.PublicKey.from_compressed(
        b"\x0a" + b"\xff" * 64),
    "NotMemberError": lambda m: m.Signature.from_uncompressed(
        P.to_bytes(32, "big") + b"\x00" * 32),
    "InvalidGroupPointError": lambda m: m.Signature.from_uncompressed(
        (1).to_bytes(32, "big") + (3).to_bytes(32, "big")),
    "InvalidGroupPointError-subgroup": lambda m: m.PublicKey.from_uncompressed(
        _twist_point_outside_subgroup()),
    "PointInJacobianError": lambda m: m.Signature(
        (1, 1, 0)).to_compressed(),
    "SerializationError": lambda m: (
        serde if m is T else jserde).private_key_from_json("[1, 2, 999]"),
    "VerificationFailedError": lambda m: m.check_public_keys(
        m.PublicKey.from_private_key(m.PrivateKey(3)),
        m.PublicKeyG1.from_private_key(m.PrivateKey(4))),
}


@pytest.mark.parametrize("case", sorted(ERROR_CASES))
def test_error_paths_raise_the_ports_class(case):
    name = case.split("-")[0]
    with pytest.raises(getattr(E, name)) as got:
        ERROR_CASES[case](T)
    assert type(got.value).__module__ == "bn254_tpu_torch.errors"
    with pytest.raises(getattr(J, name)) as want:
        ERROR_CASES[case](J)
    assert type(got.value).__name__ == type(want.value).__name__
    assert isinstance(got.value, T.Bn254Error)


def test_bit_and_affine_errors():
    """tests/test_errors.py: get_bit out of range, an identity in a
    batch headed for the device."""
    assert PC.u256_get_bit(2, 1) is True and PC.u256_get_bit(2, 0) is False
    for i in (256, -1):
        with pytest.raises(E.IndexOutOfBoundsError):
            PC.u256_get_bit(2, i)
    ident = C.g1_add(C.G1_ONE, C.g1_neg(C.G1_ONE))
    with pytest.raises(E.ToAffineConversionError):
        CV.g1_batch_to_device_affine([C.G1_ONE, ident])
    with pytest.raises(E.ToAffineConversionError):
        CV.g2_batch_to_device_affine([C.g2_add(C.G2_ONE, C.g2_neg(C.G2_ONE))])


@pytest.mark.parametrize(
    "payload", ["not json {", "[1, 2, 999]", '"a string"', "[1, -3]"])
def test_serialization_error_on_malformed_json(payload):
    with pytest.raises(E.SerializationError):
        serde.private_key_from_json(payload)
    with pytest.raises(E.SerializationError):
        serde.public_key_from_json(payload)


# ---------------------------------------------------------------------------
# host pairing (tests/test_host_pairing.py) against bn254_tpu's pure path
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("i", range(2))
def test_pairing_batch_py_equals_jax(i):
    pairs = [(g1_point(i), g2_point(i + 1)), (g1_point(i + 2), C.G2_ONE)]
    got = PR.pairing_batch_py(pairs)
    assert F.fq12_eq(got, JPR.pairing_batch_py(pairs))
    assert F.fq12_eq(PR.pairing_batch(pairs), got)


def test_pairing_laws():
    e = PR.pairing(C.G1_ONE, C.G2_ONE)
    assert not PR.gt_eq(e, PR.GT_ONE)
    assert PR.gt_eq(PR.pairing(C.g1_mul(C.G1_ONE, 2), C.G2_ONE),
                    F.fq12_mul(e, e))
    assert PR.gt_eq(PR.pairing(C.G1_ONE, C.g2_mul(C.G2_ONE, 2)),
                    F.fq12_mul(e, e))
    assert PR.gt_eq(PR.pairing_batch(
        [(C.G1_ONE, C.G2_ONE), (C.g1_neg(C.G1_ONE), C.G2_ONE)]), PR.GT_ONE)
    assert PR.gt_eq(PR.pairing(C.G1_IDENTITY, C.G2_ONE), PR.GT_ONE)
    assert PR.gt_eq(PR.pairing(C.G1_ONE, C.G2_IDENTITY), PR.GT_ONE)
    f = PR.miller_loop(PR.twist(C.g2_to_affine(C.G2_ONE)),
                       C.g1_to_affine(C.G1_ONE))
    assert F.fq12_eq(PR.structured_final_exp(f), PR.final_exponentiation(f))
    assert F.fq12_eq(F.fq12_frob(e, 1), F.fq12_pow(e, P))


# ---------------------------------------------------------------------------
# api aggregation against bn254_tpu.api
# ---------------------------------------------------------------------------


def test_api_aggregates_equal_jax():
    sigs = [T.Signature(g1_point(i)) for i in range(4)]
    pks = [T.PublicKey(g2_point(i)) for i in range(3)]
    got = api.aggregate_signatures(sigs)
    assert isinstance(got, T.Signature)
    assert got.to_compressed() == japi.aggregate_signatures(
        [J.Signature(s.point) for s in sigs]).to_compressed()
    gpk = api.aggregate_public_keys(pks)
    assert isinstance(gpk, T.PublicKey)
    assert gpk.to_compressed() == japi.aggregate_public_keys(
        [J.PublicKey(k.point) for k in pks]).to_compressed()
    assert api.aggregate_signatures(sigs[:1]) == sigs[0]
