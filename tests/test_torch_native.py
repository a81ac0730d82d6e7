"""The port's native host core (`bn254_tpu_torch/host/native.py` over
`csrc/bn254_host.cpp`) against the pure-Python oracles.

Each function of the core is held against the port's oracle and against
the JAX package's pure-Python oracle (`g1_mul_py`, `g2_mul_py`,
`pairing_batch_py`, `hash/tai.py`) on numpy-seeded inputs: scalar muls at
random scalars, 0, R and R + 5 (not reduced: the subgroup check relies on
it), the adds at the identity and a point's negation, hash-to-G1, the
pairing on the go-ethereum vectors of tests/data/bn256.json, the pairing
product and check, sign and verify with a tampered signature, the subgroup
check on a random twist point and the curve predicates. Then the dispatch
(the protocol layer counts calls into the core; with BN254_DISABLE_NATIVE
the same calls give the same bytes with no core call) and the build (two
processes on an empty build directory compile once and load the same
digest-named file; a compiler that fails raises). Skips only when no C++
compiler is on PATH.
"""

import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

from bn254_tpu.hash import tai as JTAI
from bn254_tpu.host import curve as JC
from bn254_tpu.host import pairing as JPR
from bn254_tpu_torch import ECDSA, PrivateKey, PublicKey, Signature
from bn254_tpu_torch.constants import P, R
from bn254_tpu_torch.hash import tai as TAI
from bn254_tpu_torch.host import curve as C
from bn254_tpu_torch.host import field as F
from bn254_tpu_torch.host import native as N
from bn254_tpu_torch.host import pairing as PR
from bn254_tpu_torch.kernels import build

REPO = pathlib.Path(__file__).resolve().parent.parent
with open(REPO / "tests" / "data" / "bn256.json") as fh:
    BN256_MUL = json.load(fh)["mul"]

_rng = np.random.default_rng(1515)
RANDOM = [int.from_bytes(_rng.bytes(32), "big") % R for _ in range(3)]
SCALARS = [*RANDOM, 0, R, R + 5]
SCALAR_IDS = ["random0", "random1", "random2", "zero", "R", "R+5"]
G2_AFF = C.g2_to_affine(C.G2_ONE)


@pytest.fixture(autouse=True)
def core(monkeypatch):
    """The core on, as the package's default is; skip without a compiler."""
    if N.compiler() is None:
        pytest.skip("no C++ compiler on PATH")
    monkeypatch.delenv("BN254_DISABLE_NATIVE", raising=False)
    N.library()


def canon12(a):
    return tuple(tuple(tuple(c % P for c in c2) for c2 in c6) for c6 in a)


def twist_point_outside_subgroup(rng):
    """A random point of E'(Fq2): with the large cofactor, almost surely
    not in G2."""
    while True:
        x = (int(rng.integers(1, 1 << 62)) % P, int(rng.integers(1, 1 << 62)))
        y = F.fq2_sqrt(F.fq2_add(F.fq2_mul(F.fq2_sq(x), x), C.B2))
        if y is not None:
            return x, y


@pytest.mark.parametrize("k", SCALARS, ids=SCALAR_IDS)
def test_g1_mul_equals_both_oracles(k):
    base = C.g1_mul_py(C.G1_ONE, 77)
    got = N.g1_mul(C.g1_to_affine(base), k)
    assert got == C.g1_to_affine(C.g1_mul_py(base, k))
    assert got == JC.g1_to_affine(JC.g1_mul_py(base, k))
    assert C.g1_to_affine(C.g1_mul(base, k)) == got  # the dispatch
    if k == R:
        assert got is None


@pytest.mark.parametrize("k", SCALARS, ids=SCALAR_IDS)
def test_g2_mul_equals_both_oracles(k):
    got = N.g2_mul(G2_AFF, k)
    assert got == C.g2_to_affine(C.g2_mul_py(C.G2_ONE, k))
    assert got == JC.g2_to_affine(JC.g2_mul_py(C.G2_ONE, k))
    assert C.g2_to_affine(C.g2_mul(C.G2_ONE, k)) == got
    if k in (0, R):
        assert got is None


@pytest.mark.parametrize("group", ["g1", "g2"])
def test_adds_with_identity_and_negation(group):
    mul, add = getattr(N, f"{group}_mul"), getattr(N, f"{group}_add")
    base = (1, 2) if group == "g1" else G2_AFF
    neg = F.fq_neg if group == "g1" else F.fq2_neg
    a, b = mul(base, RANDOM[0]), mul(base, RANDOM[1])
    assert add(a, b) == mul(base, (RANDOM[0] + RANDOM[1]) % R)
    assert add(a, None) == a and add(None, b) == b
    assert add(None, None) is None
    assert add(a, (a[0], neg(a[1]))) is None
    assert add(a, a) == mul(base, 2 * RANDOM[0] % R)  # the doubling branch


@pytest.mark.parametrize("msg", [b"", b"sample", b"\x00" * 33,
                                 bytes(range(200)), _rng.bytes(41)],
                         ids=["empty", "sample", "zeros33", "range200",
                              "random41"])
def test_hash_to_g1_equals_try_and_increment(msg):
    got = N.hash_to_g1(msg)
    assert got == TAI.hash_to_g1_affine(msg) == JTAI.hash_to_g1_affine(msg)


# the go-ethereum mul vectors whose result is a point: e([s]X, Q) = e(X, [s]Q)
PAIRING_VECTORS = [v for v in BN256_MUL if int(v["result"], 16)][:3]


@pytest.mark.parametrize("vec", PAIRING_VECTORS,
                         ids=range(len(PAIRING_VECTORS)))
def test_pairing_on_bn256_vectors(vec):
    x = (int(vec["x"], 16), int(vec["y"], 16))
    sx = (int(vec["result"][:64], 16), int(vec["result"][64:], 16))
    s = int(vec["scalar"], 16)
    q = N.g2_mul(G2_AFF, 5)
    got = N.pairing(sx, q)
    assert got == N.pairing(x, N.g2_mul(q, s % R))
    want = PR.pairing_batch_py([(C.g1_from_affine(sx), C.g2_from_affine(q))])
    assert got == canon12(want)
    assert got == canon12(JPR.pairing_batch_py(
        [(C.g1_from_affine(sx), C.g2_from_affine(q))]))
    assert PR.pairing(C.g1_from_affine(sx), C.g2_from_affine(q)) == got
    assert got != canon12(F.FQ12_ONE)


@pytest.mark.parametrize("n", [1, 2, 3])
def test_pairing_product_equals_pairing_batch_py(n):
    rng = np.random.default_rng(1600 + n)
    ks = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(2 * n)]
    pairs = [(C.g1_mul_py(C.G1_ONE, ks[2 * i]),
              C.g2_mul_py(C.G2_ONE, ks[2 * i + 1])) for i in range(n)]
    pairs_aff = [(C.g1_to_affine(p), C.g2_to_affine(q)) for p, q in pairs]
    got = N.pairing_product(pairs_aff)
    assert got == canon12(PR.pairing_batch_py(pairs))
    assert got == canon12(JPR.pairing_batch_py(pairs))
    assert PR.pairing_batch(pairs) == got  # the dispatch


def test_pairing_identities_and_check():
    assert N.pairing(None, G2_AFF) == canon12(F.FQ12_ONE)
    assert N.pairing((1, 2), None) == canon12(F.FQ12_ONE)
    assert N.pairing_check([(None, G2_AFF)])
    a, b = RANDOM[0], RANDOM[1]
    neg_g2 = (G2_AFF[0], F.fq2_neg(G2_AFF[1]))
    pairs = [(N.g1_mul((1, 2), a), N.g2_mul(G2_AFF, b))]
    assert N.pairing_check(pairs + [(N.g1_mul((1, 2), a * b % R), neg_g2)])
    assert not N.pairing_check(
        pairs + [(N.g1_mul((1, 2), (a * b + 1) % R), neg_g2)])


@pytest.mark.parametrize("i", range(2))
def test_sign_and_verify_with_a_tampered_signature(i):
    rng = np.random.default_rng(1700 + i)
    msg, sk = rng.bytes(int(rng.integers(0, 64))), RANDOM[i]
    pk = N.g2_mul(G2_AFF, sk)
    sig = N.sign(msg, sk)
    want = C.g1_to_affine(C.g1_mul_py(TAI.hash_to_g1(msg), sk))
    assert sig == want == JC.g1_to_affine(
        JC.g1_mul_py(JTAI.hash_to_g1(msg), sk))
    assert N.verify(msg, sig, pk)
    assert not N.verify(msg, N.g1_add(sig, (1, 2)), pk)
    assert not N.verify(msg + b"!", sig, pk)


@pytest.mark.parametrize("seed", [1801, 1802])
def test_random_twist_point_is_outside_the_subgroup(seed):
    pt = twist_point_outside_subgroup(np.random.default_rng(seed))
    assert N.g2_on_curve(pt)
    assert not N.g2_in_subgroup(pt)
    assert not C.g2_is_in_subgroup(pt)  # the dispatch
    assert not JC.g2_is_in_subgroup(pt)
    assert not C.jac_is_identity(C.g2_mul_py(C.g2_from_affine(pt), R),
                                 C.FQ2_OPS)  # the oracle agrees
    assert N.g2_mul(pt, R) is not None  # [R]P is computed, not reduced


def test_curve_predicates():
    assert N.g1_on_curve((1, 2)) and not N.g1_on_curve((1, 3))
    assert N.g1_on_curve(None) and N.g2_on_curve(None)
    assert N.g2_on_curve(G2_AFF)
    assert not N.g2_on_curve((G2_AFF[0], F.fq2_add(G2_AFF[1], (1, 0))))
    assert N.g2_in_subgroup(G2_AFF) and N.g2_in_subgroup(None)
    assert N.g2_in_subgroup(N.g2_mul(G2_AFF, RANDOM[2]))


SK_HEX = "2009da7287c158b126123c113d1c85241b6e3294dd75c643588630a8bc0f934c"
FLOW = f"""
import json, sys
from bn254_tpu_torch import ECDSA, PrivateKey, PublicKey, Signature
from bn254_tpu_torch.host import native as N
sk = PrivateKey.from_hex("{SK_HEX}")
pk = PublicKey.from_private_key(sk)
sig = ECDSA.sign(b"sample", sk)
ECDSA.verify(b"sample", sig, pk)
pk2 = PublicKey.from_compressed(pk.to_compressed())
ECDSA.verify(b"sample", Signature.from_compressed(sig.to_compressed()), pk2)
print(json.dumps({{"pk": pk2.to_compressed().hex(),
                  "sig": sig.to_compressed().hex(),
                  "calls": sum(N.calls.values())}}))
"""


def test_protocol_layer_counts_its_calls_into_the_core():
    """ECDSA.sign / verify, PublicKey.from_private_key and from_compressed
    each go through the core: its counts rise by exactly their calls."""
    before = dict(N.calls)
    sk = PrivateKey.from_hex(SK_HEX)
    pk = PublicKey.from_private_key(sk)
    sig = ECDSA.sign(b"sample", sk)
    ECDSA.verify(b"sample", sig, pk)
    PublicKey.from_compressed(pk.to_compressed())
    rose = {k: v - before[k] for k, v in N.calls.items() if v != before[k]}
    assert rose == {"g2_mul": 1, "g1_mul": 1, "pairing_product": 1,
                    "g2_in_subgroup": 1}


def test_disabled_core_gives_the_same_bytes_with_no_call():
    """BN254_DISABLE_NATIVE selects the oracle: the same flow in a fresh
    process gives the same bytes with zero calls into the core."""
    outs = {}
    for tag, env in (("core", {}), ("oracle", {"BN254_DISABLE_NATIVE": "1"})):
        r = subprocess.run([sys.executable, "-c", FLOW], cwd=REPO,
                           capture_output=True, text=True, timeout=300,
                           env={**os.environ, **env})
        assert r.returncode == 0, r.stderr
        outs[tag] = json.loads(r.stdout.splitlines()[-1])
    assert outs["core"]["calls"] == 5 and outs["oracle"]["calls"] == 0
    assert outs["core"]["pk"] == outs["oracle"]["pk"]
    assert outs["core"]["sig"] == outs["oracle"]["sig"]


def test_no_compiler_selects_the_oracle(monkeypatch):
    """Without a compiler on PATH (or with BN254_DISABLE_NATIVE) the host
    paths take the oracle and never call into the core."""
    before = sum(N.calls.values())
    monkeypatch.setenv("CXX", "/nonexistent/c++")
    assert not N.available()
    want = C.g2_to_affine(C.g2_mul_py(C.G2_ONE, 9))
    assert C.g2_to_affine(C.g2_mul(C.G2_ONE, 9)) == want
    monkeypatch.delenv("CXX")
    monkeypatch.setenv("BN254_DISABLE_NATIVE", "1")
    assert not N.available()
    assert C.g2_is_in_subgroup(G2_AFF)
    assert sum(N.calls.values()) == before


BUILD = """
import sys
from pathlib import Path
from bn254_tpu_torch.host import native as N
from bn254_tpu_torch.kernels import build
build.BUILD_DIR = Path(sys.argv[1])
N.library()
print(N.output().name, N.g1_mul((1, 2), 3) == (
    0x769BF9AC56BEA3FF40232BCB1B6BD159315D84715B8E679F2D355961915ABF0,
    0x2AB799BEE0489429554FDB7C8D086475319E63B40B9C5B57CDF1FF3DD9FE2261))
"""


def test_two_processes_build_once_and_load_the_same_file(tmp_path):
    """Two processes on an empty build directory: the compiler runs once
    (an fcntl lock), both load the same digest-named file, and no
    temporary file is left."""
    log = tmp_path / "cxx.log"
    cxx = tmp_path / "cxx"
    cxx.write_text(f'#!/bin/sh\necho run >> {log}\nexec {N.compiler()} "$@"\n')
    cxx.chmod(0o755)
    out_dir = tmp_path / "out"
    procs = [subprocess.Popen([sys.executable, "-c", BUILD, str(out_dir)],
                              cwd=REPO, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True,
                              env={**os.environ, "CXX": str(cxx)})
             for _ in range(2)]
    outs = [p.communicate(timeout=300) for p in procs]
    assert all(p.returncode == 0 for p in procs), [e for _, e in outs]
    names = {o.split()[0] for o, _ in outs}
    assert names == {N.output().name} and all(
        o.split()[1] == "True" for o, _ in outs)
    assert log.read_text().split() == ["run"]
    assert sorted(f.name for f in out_dir.iterdir()) == sorted(
        [N.output().name, N.output().with_suffix(".lock").name])


def test_failing_compiler_raises_and_does_not_fall_back(monkeypatch,
                                                        tmp_path):
    """A compiler that is present but fails (CXX=false): the core is
    available, so the host paths raise KernelBuildError instead of taking
    the oracle, and nothing is left in the build directory but the lock."""
    monkeypatch.setenv("CXX", "false")
    monkeypatch.setattr(build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(N, "_lib", None)
    assert N.available()
    before = sum(N.calls.values())
    with pytest.raises(build.KernelBuildError, match="bn254_host.cpp"):
        N.library()
    with pytest.raises(build.KernelBuildError):
        C.g1_mul(C.G1_ONE, 5)
    with pytest.raises(build.KernelBuildError):
        ECDSA.verify(b"m", Signature(C.G1_ONE), PublicKey(C.G2_ONE))
    assert sum(N.calls.values()) == before
    assert [f.suffix for f in tmp_path.iterdir()] == [".lock"]
