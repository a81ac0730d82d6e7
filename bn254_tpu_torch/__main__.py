"""Command-line interface: `python -m bn254_tpu_torch <command>`.

A thin operational wrapper over the protocol API, with the subcommands,
output lines and exit codes of `python -m bn254_tpu`; hex I/O on
stdin/stdout:

  keygen                          -> sk_hex pk_compressed_hex
  pubkey  <sk_hex>                -> pk_compressed_hex
  sign    <sk_hex> <msg>          -> sig_compressed_hex
  verify  <pk_hex> <sig_hex> <msg>   (exit 0 accept / 1 reject)
  aggregate-sigs <sig_hex>...     -> sig_compressed_hex
  aggregate-pks  <pk_hex>...      -> pk_compressed_hex
  hash-to-g1 <msg>                -> g1_compressed_hex
  batch-verify                    (JSON lines {"msg","sig","pk"} on
                                   stdin; the device batch pipeline,
                                   `api.batch_verify(mode="independent")`;
                                   prints one ok/FAIL line per tuple,
                                   exit 1 if any fails)

Messages are UTF-8 strings; pass --hex-msg for hex-encoded bytes.
`--device` names the torch device of batch-verify: the CUDA card by
default, which must exist (`--device cpu` runs it on the CPU). The other
subcommands run on the host: they import no torch and touch no device.
"""

from __future__ import annotations

import argparse
import functools
import json
import sys


def _msg_bytes(s: str, hex_msg: bool) -> bytes:
    return bytes.fromhex(s) if hex_msg else s.encode()


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="bn254_tpu_torch")
    ap.add_argument("--hex-msg", action="store_true",
                    help="treat message arguments as hex-encoded bytes")
    ap.add_argument("--device", default=None,
                    help="torch device of batch-verify (default: the CUDA "
                         "card)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    sub.add_parser("keygen")
    p = sub.add_parser("pubkey")
    p.add_argument("sk")
    p = sub.add_parser("sign")
    p.add_argument("sk")
    p.add_argument("msg")
    p = sub.add_parser("verify")
    p.add_argument("pk")
    p.add_argument("sig")
    p.add_argument("msg")
    p = sub.add_parser("aggregate-sigs")
    p.add_argument("sigs", nargs="+")
    p = sub.add_parser("aggregate-pks")
    p.add_argument("pks", nargs="+")
    p = sub.add_parser("hash-to-g1")
    p.add_argument("msg")
    sub.add_parser("batch-verify")
    args = ap.parse_args(argv)

    from . import ECDSA, PrivateKey, PublicKey, Signature
    from .errors import VerificationFailedError

    mb = functools.partial(_msg_bytes, hex_msg=args.hex_msg)

    if args.cmd == "keygen":
        sk = PrivateKey.random()
        pk = PublicKey.from_private_key(sk)
        print(sk.to_hex(), pk.to_compressed().hex())
    elif args.cmd == "pubkey":
        pk = PublicKey.from_private_key(PrivateKey.from_hex(args.sk))
        print(pk.to_compressed().hex())
    elif args.cmd == "sign":
        sig = ECDSA.sign(mb(args.msg), PrivateKey.from_hex(args.sk))
        print(sig.to_compressed().hex())
    elif args.cmd == "verify":
        try:
            ECDSA.verify(
                mb(args.msg),
                Signature.from_compressed(bytes.fromhex(args.sig)),
                PublicKey.from_compressed(bytes.fromhex(args.pk)),
            )
        except VerificationFailedError:
            print("FAIL")
            return 1
        print("ok")
    elif args.cmd == "aggregate-sigs":
        sigs = [Signature.from_compressed(bytes.fromhex(s)) for s in args.sigs]
        agg = sigs[0]
        for s in sigs[1:]:
            agg = agg + s
        print(agg.to_compressed().hex())
    elif args.cmd == "aggregate-pks":
        pks = [PublicKey.from_compressed(bytes.fromhex(s)) for s in args.pks]
        agg = pks[0]
        for s in pks[1:]:
            agg = agg + s
        print(agg.to_compressed().hex())
    elif args.cmd == "hash-to-g1":
        from .codec.points import g1_to_compressed
        from .hash.tai import hash_to_g1

        print(g1_to_compressed(hash_to_g1(mb(args.msg))).hex())
    elif args.cmd == "batch-verify":
        from . import api

        tuples = [json.loads(line) for line in sys.stdin if line.strip()]
        msgs = [mb(t["msg"]) for t in tuples]
        sigs = [
            Signature.from_compressed(bytes.fromhex(t["sig"])) for t in tuples
        ]
        pks = [
            PublicKey.from_compressed(bytes.fromhex(t["pk"])) for t in tuples
        ]
        oks = api.batch_verify(msgs, sigs, pks, mode="independent",
                               device=args.device)
        rc = 0
        for t, ok in zip(tuples, oks):
            print(f"{'ok' if ok else 'FAIL'} {t['msg']}")
            rc |= 0 if ok else 1
        return rc
    return 0


if __name__ == "__main__":
    sys.exit(main())
