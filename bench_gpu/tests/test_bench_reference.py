"""The reference against the port's host arithmetic, the inputs it makes,
and what the harness loads."""

import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from bench_gpu import inputs
from bench_gpu.reference import bls

REPO = Path(__file__).resolve().parents[2]
MESSAGES = [b"", b"sample", bytes(range(32)), b"\xff" * 41]


@pytest.mark.parametrize("m", MESSAGES)
def test_hash_to_g1_matches_the_port(m):
    from bn254_tpu_torch.hash.tai import hash_to_g1_affine

    assert bls.hash_to_g1(m) == hash_to_g1_affine(m)


def test_scalar_muls_match_the_port():
    from bn254_tpu_torch.host import curve as HC

    h = bls.hash_to_g1(b"sample")
    for k in (1, 2, 3, (1 << 63) | 12345, bls.R - 1):
        assert bls.g1_mul(h, k) == HC.g1_to_affine(
            HC.g1_mul_py(HC.g1_from_affine(h), k))
    for k in (2, (1 << 63) | 777):
        assert bls.public_key(k) == HC.g2_to_affine(HC.g2_mul_py(HC.G2_ONE,
                                                                 k))


def test_verdicts_agree_with_the_ports_host_pairing():
    """valid() against e(H(m), pk) == e(sig, G2) on the port's host oracle."""
    from bn254_tpu_torch.host import curve as HC
    from bn254_tpu_torch.host import pairing as HP

    sk = (1 << 63) | 99
    pk = HC.g2_from_affine(bls.public_key(sk))
    good = bls.sign(b"a", sk)
    bad = bls.sign(b"b", sk)
    for sig in (good, bad):
        lhs = HP.pairing(HC.g1_from_affine(bls.hash_to_g1(b"a")), pk)
        rhs = HP.pairing(HC.g1_from_affine(sig), HC.G2_ONE)
        assert (lhs == rhs) == bls.valid(b"a", sig, sk)


CFG = {"tuples": 6, "keys": 4, "key_bits": 64}
TRAFFIC = {"message_bytes": 32, "distinct_batches": 2,
           "rotation": [{"batch": 0, "invalid": 0}, {"batch": 1, "invalid": 2},
                        {"batch": 0, "invalid": 1}]}


def test_inputs_follow_the_seed_and_the_cache(tmp_path):
    made = inputs.ensure("x", CFG, TRAFFIC, 2**33 + 5, tmp_path)
    made_again = inputs.ensure("x", CFG, TRAFFIC, 2**33 + 5, tmp_path)
    a = inputs.make(CFG, TRAFFIC, 2**33 + 5)
    b = inputs.load("x", CFG, TRAFFIC, 2**33 + 5, tmp_path)
    c = inputs.make(CFG, TRAFFIC, 2**33 + 6)
    assert made and not made_again
    assert a.messages == b.messages and a.sigs == b.sigs
    assert a.public_keys == b.public_keys and c.messages != a.messages
    assert a.secret_keys == b.secret_keys
    for e, f in zip(a.entries, b.entries):
        assert e.batch == f.batch and e.bad_sig == f.bad_sig
        assert np.array_equal(e.bad_index, f.bad_index)
        assert np.array_equal(e.expected, f.expected)
    assert [int((~e.expected).sum()) for e in a.entries] == [0, 2, 1]


@pytest.mark.parametrize("seed", [3, 2**31 + 9])
def test_bad_tuples_lie_within_their_share(seed):
    traffic = {**TRAFFIC, "rotation": [
        {"batch": 0, "invalid": 1, "within": [q / 3, (q + 1) / 3]}
        for q in range(3)]}
    data = inputs.make(CFG, traffic, seed)
    assert all(2 * q <= e.bad_index[0] < 2 * q + 2
               for q, e in enumerate(data.entries))
    assert [int(np.flatnonzero(~e.expected)[0]) for e in data.entries] == [
        int(e.bad_index[0]) for e in data.entries]


def test_glv_sum_is_the_weighted_sum():
    """g1_glv_sum against the sum of the scalar products, the weight taken
    whole as a + lambda b mod R, and against the port's host oracle."""
    from bn254_tpu_torch.host import curve as HC

    lam = bls.GLV_LAMBDA
    assert (lam * lam + lam + 1) % bls.R == 0
    pts = [bls.hash_to_g1(bytes([i])) for i in range(7)]
    a = [0, 1, (1 << 64) - 1, 5, 0, 77, 1 << 63]
    b = [1, 0, 3, (1 << 64) - 1, 0, 1 << 40, 9]
    acc = None
    for ai, bi, p in zip(a, b, pts):
        w = (ai + lam * bi) % bls.R
        if w == 0:
            continue
        term = HC.g1_mul_py(HC.g1_from_affine(p), w)
        acc = term if acc is None else HC.g1_add(acc, term)
    assert bls.g1_glv_sum(a, b, pts) == HC.g1_to_affine(acc)
    assert bls.g1_glv_sum([0] * 3, [0] * 3, pts[:3]) is None
    # a point and its negative cancel
    x, y = pts[0]
    assert bls.g1_msm([1, 1], [(x, y), (x, bls.P - y)]) is None


def test_every_verdict_is_the_bls_relation():
    data = inputs.make(CFG, TRAFFIC, 7)
    sks = data.secret_keys
    assert all(k >> 63 == 1 for k in sks)
    assert [bls.public_key(k) for k in sks] == data.public_keys
    for e in data.entries:
        msgs = data.messages[e.batch]
        ki = data.key_index[e.batch]
        got = [bls.valid(m, s, sks[k])
               for m, s, k in zip(msgs, data.sigs_of(e), ki.tolist())]
        assert got == e.expected.tolist()


def _python(code, env=None, cwd=REPO):
    return subprocess.run([sys.executable, "-c", code], cwd=cwd,
                          capture_output=True, text=True, timeout=300,
                          env={**os.environ, **(env or {})})


def test_nothing_the_harness_runs_loads_jax_or_the_jax_package():
    code = """
import sys, json
from bench_gpu import control, faults, harness, inputs, run, spec, tracing
from bench_gpu.reference import bls
for m in spec.benchmark()["end_to_end"] + spec.benchmark()["per_layer"]:
    spec.reader(m["name"])
for c in spec.benchmark()["configs"]:
    spec.entry(spec.config(c["name"])["entry"])
import bn254_tpu_torch.api, bn254_tpu_torch.dist.batch_verify
for name in faults.FAULTS:
    with faults.planted(name):
        pass
print(json.dumps(sorted({m.split(".")[0] for m in sys.modules})))
"""
    r = _python(code)
    assert r.returncode == 0, r.stderr
    top = set(json.loads(r.stdout.splitlines()[-1]))
    assert "bn254_tpu_torch" in top
    assert not top & {"jax", "jaxlib", "flax", "bn254_tpu"}


def test_the_reference_imports_nothing_of_the_program():
    r = _python("import sys, bench_gpu.reference.bls; "
                "print(sorted({m.split('.')[0] for m in sys.modules}))")
    assert r.returncode == 0, r.stderr
    assert "bn254_tpu_torch" not in r.stdout and "torch" not in r.stdout


def test_run_refuses_without_a_card_and_prints_nothing():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = subprocess.run([sys.executable, "-m", "bench_gpu.run", "--workload",
                        "cfg4-b8192-valid", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode != 0 and r.stdout == ""


def test_run_refuses_a_knob():
    r = subprocess.run([sys.executable, "-m", "bench_gpu.run", "--workload",
                        "cfg4-b8192-valid", "--seed", "1", "--seconds", "1",
                        "--trace", "0"], cwd=REPO, capture_output=True,
                       text=True, timeout=300,
                       env={**os.environ, "BN254_RLC_BITS": "64"})
    assert r.returncode != 0 and r.stdout == "" and "BN254_RLC_BITS" in r.stderr
