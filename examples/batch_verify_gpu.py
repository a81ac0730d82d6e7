#!/usr/bin/env python
"""Batched BLS verification on an NVIDIA card (the throughput workload).

    python examples/batch_verify_gpu.py [n]

Signs n (default 16) messages on the host with `ECDSA.sign`, moves the
(message, signature, public key) tuples to the card as Montgomery limb
tensors, and verifies them with bn254_tpu_torch's CUDA pipeline in both
modes:

  * independent — per-tuple accept/reject (exact reference `verify`
    semantics tuple by tuple)
  * fused — one combined product check with random linear-combination
    weights and a single shared final exponentiation

Then swaps one signature and checks that both modes catch it. It needs a
CUDA card (there is no quiet CPU run) and exits non-zero if a check fails.
"""

import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from bn254_tpu_torch import ECDSA, PrivateKey, PublicKey, api  # noqa: E402


def main() -> int:
    n = int(sys.argv[1]) if len(sys.argv) > 1 else 16
    if n < 5:
        print("n must be at least 5", file=sys.stderr)
        return 2
    messages = [b"message-%05d" % i for i in range(n)]
    keys = [PrivateKey(0x1234567 + 977 * i) for i in range(n)]
    pks = [PublicKey.from_private_key(k) for k in keys]

    t0 = time.time()
    sigs = [ECDSA.sign(m, k) for m, k in zip(messages, keys)]
    print(f"signed {n} messages host-side in {time.time() - t0:.2f}s")

    t0 = time.time()
    ok = api.batch_verify(messages, sigs, pks, mode="independent")
    print(f"independent batch verify: all={ok.all()} "
          f"({time.time() - t0:.2f}s incl. kernel build)")

    t0 = time.time()
    ok_fused = api.batch_verify(messages, sigs, pks, mode="fused")
    print(f"fused batch verify: {ok_fused} ({time.time() - t0:.2f}s)")
    if not (ok.all() and ok_fused):
        print("a valid batch was rejected", file=sys.stderr)
        return 1

    # a tampered signature must be caught
    bad_sigs = list(sigs)
    bad_sigs[3] = sigs[4]
    ok = api.batch_verify(messages, bad_sigs, pks, mode="independent")
    if ok[3] or ok.sum() != n - 1:
        print(f"independent mode flagged {(~ok).nonzero()[0].tolist()}, "
              "want [3]", file=sys.stderr)
        return 1
    if api.batch_verify(messages, bad_sigs, pks, mode="fused"):
        print("fused mode accepted the tampered batch", file=sys.stderr)
        return 1
    print("tampered tuple correctly rejected in both modes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
