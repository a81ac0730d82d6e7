"""The port's CLI (`python -m bn254_tpu_torch`) against `python -m bn254_tpu`.

Every deterministic subcommand prints byte for byte what the JAX package's
CLI prints, with the same exit code (tests/test_cli.py's flows and more
arguments). batch-verify runs `api.batch_verify(mode="independent")` on
the device `--device` names: here on 4 tuples of 4 message lengths, one
tampered, through the card's composition with the g++ build of `fused.cu`
standing in for the card (the `host_card` fixture of
tests/test_torch_fused_host.py; the plain CPU path takes ~30 s), with
chip_smoke.py's launch table for the path; without a card and without
`--device` it raises the api's CUDA error. The host subcommands import no
torch.
"""

import io
import json
import pathlib
import subprocess
import sys

import pytest
import torch

import chip_smoke
from bn254_tpu.__main__ import main as jcli
from bn254_tpu_torch import ECDSA, PrivateKey, PublicKey
from bn254_tpu_torch.__main__ import main as cli
from bn254_tpu_torch.kernels import fused as FK
from test_torch_fused_host import host_card, host_lib  # noqa: F401

REPO = pathlib.Path(__file__).resolve().parent.parent

SK1 = "c9afa9d845ba75166b5c215767b1d6934e50c3db36e89b127b8a622b120f6721"
SK2 = "a55e93edb1350916bf5beea1b13d8f198ef410033445bcb645b65be5432722f1"
SK3 = "2009da7287c158b126123c113d1c85241b6e3294dd75c643588630a8bc0f934c"


def pk_hex(sk):
    return PublicKey.from_private_key(PrivateKey.from_hex(sk)) \
        .to_compressed().hex()


def sig_hex(sk, msg: bytes):
    return ECDSA.sign(msg, PrivateKey.from_hex(sk)).to_compressed().hex()


def agg_sig():
    return [sig_hex(SK1, b"sample"), sig_hex(SK2, b"sample")]


def agg_pk():
    return [pk_hex(SK1), pk_hex(SK2)]


def run(capsys, fn, argv):
    rc = fn(list(argv))
    return rc, capsys.readouterr().out


# argv of each deterministic case, built lazily (signing takes a moment)
CASES = {
    "pubkey-1": lambda: ["pubkey", SK1],
    "pubkey-3": lambda: ["pubkey", SK3],
    "sign": lambda: ["sign", SK1, "sample"],
    "sign-unicode": lambda: ["sign", SK2, "héllo wörld"],
    "sign-hex-msg": lambda: ["--hex-msg", "sign", SK3, "73616d706c65"],
    "aggregate-sigs": lambda: ["aggregate-sigs", *agg_sig()],
    "aggregate-sigs-one": lambda: ["aggregate-sigs", agg_sig()[0]],
    "aggregate-pks": lambda: ["aggregate-pks", *agg_pk()],
    "aggregate-pks-three": lambda: ["aggregate-pks", *agg_pk(), pk_hex(SK3)],
    "hash-to-g1": lambda: ["hash-to-g1", "sample"],
    "hash-to-g1-empty": lambda: ["hash-to-g1", ""],
    "hash-to-g1-hex-msg": lambda: ["--hex-msg", "hash-to-g1", "00ff10"],
    "verify-ok": lambda: ["verify", pk_hex(SK3), sig_hex(SK3, b"sample"),
                          "sample"],
    "verify-fail": lambda: ["verify", pk_hex(SK1), sig_hex(SK3, b"sample"),
                            "sample"],
    "verify-hex-msg": lambda: ["--hex-msg", "verify", pk_hex(SK3),
                               sig_hex(SK3, b"sample"), "73616d706c65"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_stdout_byte_identical_to_jax_cli(capsys, case):
    argv = CASES[case]()
    got = run(capsys, cli, argv)
    assert got == run(capsys, jcli, argv)
    assert got[0] == (1 if case == "verify-fail" else 0)


def test_sign_verify_aggregate_flow(capsys):
    """tests/test_cli.py's flow: the aggregate verifies on its message and
    fails (rc 1, FAIL) on another; hash-to-g1's golden value."""
    outs = {}
    for name, argv in [("pk1", ["pubkey", SK1]), ("pk2", ["pubkey", SK2]),
                       ("s1", ["sign", SK1, "sample"]),
                       ("s2", ["sign", SK2, "sample"])]:
        rc, outs[name] = run(capsys, cli, argv)
        assert rc == 0
    rc, sig = run(capsys, cli, ["aggregate-sigs", outs["s1"].strip(),
                                outs["s2"].strip()])
    rc, pk = run(capsys, cli, ["aggregate-pks", outs["pk1"].strip(),
                               outs["pk2"].strip()])
    assert run(capsys, cli, ["verify", pk.strip(), sig.strip(),
                             "sample"]) == (0, "ok\n")
    assert run(capsys, cli, ["verify", pk.strip(), sig.strip(),
                             "tampered"]) == (1, "FAIL\n")
    assert run(capsys, cli, ["hash-to-g1", "sample"]) == (0, (
        "0211e028f08c500889891cc294fe758a60e84495ec1e2d0bce208c9fc67b6486fd"
        "\n"))


def test_keygen_roundtrip(capsys):
    rc, out = run(capsys, cli, ["keygen"])
    sk, pk = out.split()
    assert rc == 0 and run(capsys, cli, ["pubkey", sk]) == (0, pk + "\n")
    assert run(capsys, jcli, ["pubkey", sk]) == (0, pk + "\n")


def test_host_subcommands_import_no_torch():
    code = ("import sys\n"
            "from bn254_tpu_torch.__main__ import main\n"
            f"main(['sign', '{SK1}', 'sample'])\n"
            "main(['hash-to-g1', 'sample'])\n"
            "print('torch' in sys.modules)\n")
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.splitlines()[-1] == "False"


MSGS = ["alpha", "bee", "gamma-longer-msg", "dz"]  # 4 lengths


def batch_lines():
    """tests/test_cli.py's 4 mixed-length tuples, the last one's signature
    made over another message."""
    lines = []
    for i, m in enumerate(MSGS):
        sk = SK1 if i % 2 == 0 else SK2
        sig = sig_hex(SK1, b"other") if i == 3 else sig_hex(sk, m.encode())
        lines.append(json.dumps({"msg": m, "sig": sig, "pk": pk_hex(sk)}))
    return "\n".join(lines) + "\n"


def test_batch_verify_mixed_lengths_through_the_card_kernels(
        capsys, monkeypatch, host_card):
    monkeypatch.setattr(sys, "stdin", io.StringIO(batch_lines()))
    rc = cli(["--device", "cpu", "batch-verify"])
    out = capsys.readouterr().out.splitlines()
    assert rc == 1
    assert out == [f"{v} {m}" for v, m in zip(["ok", "ok", "ok", "FAIL"],
                                               MSGS)]
    assert chip_smoke.cli_launch_faults(dict(FK.launches), len(MSGS)) == []


def test_batch_verify_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(sys, "stdin", io.StringIO(batch_lines()))
    with pytest.raises(RuntimeError, match="CUDA"):
        cli(["batch-verify"])


def test_batch_verify_module_entry_needs_a_card():
    """`python -m bn254_tpu_torch batch-verify` with no `--device` on a
    machine without a card: the CUDA error, no result lines."""
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA card")
    r = subprocess.run([sys.executable, "-m", "bn254_tpu_torch",
                        "batch-verify"], input=batch_lines(), cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode != 0
    assert "RuntimeError" in r.stderr and "CUDA" in r.stderr
    assert r.stdout == ""
