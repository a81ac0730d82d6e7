#!/usr/bin/env python3
"""Smoke run of bn254_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py [--batch 8192] [--keys 16] [--seed 2026]

Phases, each of which exits non-zero on failure:

1. The card: name and power limit (nvidia-smi), torch and CUDA versions.
2. The kernel build: nvcc compiles bn254_tpu_torch/kernels/montmul.cu.
3. Kernel vs plain: the CUDA montmul against its plain torch version,
   bit for bit, on random limbs at the main path's widest shape
   (54 x batch lanes), a lane count that is no multiple of the block,
   lazy boundary limbs, a broadcast operand, and an 8-lane sample against
   the Python-int Montgomery oracle.
4. The main path through the user entry points: `api.batch_sign` makes
   the signatures of `batch` distinct messages under `keys` keys (8 held
   against the host oracle), then `api.batch_verify(mode="adaptive")`
   must accept all; `mode="fused"` must reject the batch with one
   signature swapped; `mode="adaptive"` on a tampered 64-tuple batch must
   flag exactly the tampered index. The kernel's launch count is reset
   just before the adaptive run and read just after.
5. Times on a warm repeat (CUDA events): per stage, end to end, the
   montmul launches per verify, and the device busy share of one Miller
   digit (profiler kernel time over its wall time).

It prints a kernels JSON line, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 at 3.35 TB/s; 67 TFLOP/s float32
# outside the tensor cores = 132 SMs x 128 FP32 lanes x 2 (FMA) x 1.98 GHz.
# Hopper has half as many INT32 lanes as FP32 lanes per SM, so its 32-bit
# integer multiply-add rate is 67e12 / 2 (lanes) / 2 (FMA counted once).
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 4


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr)
    sys.exit(1)


def card_line() -> str:
    r = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60,
    )
    if r.returncode != 0:
        fail(f"nvidia-smi failed: {r.stderr.strip()}")
    return r.stdout.strip().splitlines()[0]


def events_ms(torch, fn, reps: int = 1):
    """(last result, mean ms) of `reps` calls between two CUDA events."""
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        out = fn()
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end) / reps


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--keys", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2026)
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    try:
        from bn254_tpu_torch import api
        from bn254_tpu_torch.constants import MONT_R, NLIMBS, P, R
        from bn254_tpu_torch.dist import batch_verify as BV
        from bn254_tpu_torch.fields import limbs as L
        from bn254_tpu_torch.fields import tower as T
        from bn254_tpu_torch.hash.tai import hash_to_g1
        from bn254_tpu_torch.hash.tai_batch import hash_to_g1_device
        from bn254_tpu_torch.host import curve as HC
        from bn254_tpu_torch.kernels import build
        from bn254_tpu_torch.kernels import montmul as MK
        from bn254_tpu_torch.pairing import final_exp as FE
        from bn254_tpu_torch.pairing import miller as M
        from bn254_tpu_torch.utils import convert as CV
    except ImportError as e:
        print(f"chip_smoke: the bn254_tpu_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 3

    dev = torch.device("cuda")
    B = args.batch

    # -- 1. the card ---------------------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | python {sys.version.split()[0]}")

    # -- 2. the kernel build ---------------------------------------------------
    t0 = time.perf_counter()
    try:
        build.library("montmul")
    except build.KernelBuildError as e:
        fail(str(e))
    build_s = time.perf_counter() - t0
    nvcc = build.nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(f"build: {nvcc} ({ver[-1] if ver else '?'}) montmul.cu in {build_s:.2f} s")
    for line in build.build_log.get("montmul", "").splitlines():
        if "registers" in line or "spill" in line:
            print(f"build: ptxas: {line.strip()}")

    # -- 3. kernel vs plain ----------------------------------------------------
    gen = torch.Generator(device="cpu").manual_seed(args.seed)

    def rand_limbs(n, top_bits=7):
        """Lazy limbs < 2^16, top limb < 2^top_bits: value < 2^(255+top)."""
        x = torch.randint(0, 1 << 16, (NLIMBS, n), generator=gen, dtype=torch.int64)
        x[NLIMBS - 1] = torch.randint(0, 1 << top_bits, (n,), generator=gen)
        return x.to(dev)

    max_err = 0

    def check(tag, a, b):
        nonlocal max_err
        got = MK.montmul_cuda(a, b)
        want = MK.montmul_plain(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item()) if got.numel() else 0
        max_err = max(max_err, err)
        if not torch.equal(got, want):
            fail(f"montmul kernel differs from plain on {tag}: max |err| {err}")
        print(f"kernel vs plain: {tag}: {tuple(got.shape)} bit-exact")
        return got

    wide = 54 * B
    a_w, b_w = rand_limbs(wide), rand_limbs(wide)
    check("random limbs, 54 x batch lanes", a_w, b_w)
    check("ragged lane count", rand_limbs(100_003), rand_limbs(100_003))
    lazy = torch.full((NLIMBS, 4096), (1 << 16) - 1, dtype=torch.int64, device=dev)
    lazy[NLIMBS - 1] = 0x7F
    vmax = int(L.to_ints(lazy[:, :1])[0]) + 1
    assert vmax * vmax + MONT_R * P < 1 << 538
    check("lazy boundary limbs 2^16-1", lazy, lazy)
    check("broadcast (18, 1) x (18, N)", rand_limbs(1), rand_limbs(8192))
    sa, sb = rand_limbs(8), rand_limbs(8)
    got = check("8-lane oracle sample", sa, sb)
    rinv = pow(MONT_R, -1, P)
    for x, y, g in zip(L.to_ints(sa), L.to_ints(sb), L.to_ints(got)):
        if int(g) % P != int(x) * int(y) * rinv % P or int(g) >> 270:
            fail("montmul kernel disagrees with the Python-int oracle")
    print("kernel vs oracle: 8 lanes agree by value")

    # -- 4. the main path --------------------------------------------------------
    rng = np.random.default_rng(args.seed)
    msgs = [rng.bytes(32) for _ in range(B)]
    if len(set(msgs)) != B:
        fail("message fixture is not distinct")
    sks = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(args.keys)]
    key_of = [i % args.keys for i in range(B)]
    pk_pts = [HC.g2_mul(HC.G2_ONE, k) for k in sks]

    class Key:
        def __init__(self, point):
            self.point = point

    pks = [Key(pk_pts[key_of[i]]) for i in range(B)]

    t0 = time.perf_counter()
    sigs = api.batch_sign(msgs, [sks[key_of[i]] for i in range(B)])
    torch.cuda.synchronize()
    sign_s = time.perf_counter() - t0
    for i in rng.choice(B, size=min(8, B), replace=False):
        want = HC.g1_mul(hash_to_g1(msgs[i]), sks[key_of[i]])
        if not HC.g1_eq(sigs[i].point, want):
            fail(f"batch_sign disagrees with the host oracle at {i}")
    print(f"sign: {B} signatures in {sign_s:.2f} s; {min(8, B)} agree with "
          "the host oracle")

    MK.launches = 0
    t0 = time.perf_counter()
    ok = api.batch_verify(msgs, sigs, pks, mode="adaptive")
    torch.cuda.synchronize()
    cold_s = time.perf_counter() - t0
    main_launches = MK.launches
    if main_launches == 0:
        fail("the main path launched no montmul kernel")
    if ok.shape != (B,) or not ok.all():
        fail(f"adaptive rejected a valid batch: {int((~ok).sum())} false")
    print(f"verify adaptive B={B}: all {B} valid, {cold_s:.2f} s cold, "
          f"{main_launches} montmul launches")

    swapped = list(sigs)
    swapped[B // 3] = sigs[B // 3 + 1]
    if api.batch_verify(msgs, swapped, pks, mode="fused"):
        fail("fused accepted a batch with a swapped signature")
    print("verify fused: rejects the batch with one signature swapped")

    small, bad_i = min(64, B), min(17, B - 1)
    tampered = list(sigs[:small])
    tampered[bad_i] = api.Signature(HC.g1_mul(sigs[bad_i].point, 2))
    ok64 = api.batch_verify(msgs[:small], tampered, pks[:small], mode="adaptive")
    if ok64.tolist() != [i != bad_i for i in range(small)]:
        fail(f"adaptive B={small} flagged {np.flatnonzero(~ok64).tolist()}, "
             f"want [{bad_i}]")
    print(f"verify adaptive B={small}: exactly index {bad_i} rejected")

    # -- 5. times on a warm repeat ---------------------------------------------------
    with torch.inference_mode():
        (hx, hy), hash_ms = events_ms(
            torch, lambda: hash_to_g1_device(msgs, None, dev))
        sx, sy = CV.g1_batch_to_device_affine([s.point for s in sigs], dev)
        pqx, pqy = CV.g2_batch_to_device_affine(
            [k.point for k in pks], dev)
        w = BV.random_weights(B, 128, dev)
        pts, points_ms = events_ms(torch, lambda: BV._fused_points(
            hx, hy, sx, sy, pqx, pqy, w, w.half_bits))
        f_red, miller_ms = events_ms(torch, lambda: BV._miller_reduce(*pts))
        one, fe_ms = events_ms(
            torch, lambda: T.fq12_is_one(FE.final_exp(f_red)))
        if not bool(one):
            fail("the stage-by-stage fused check rejected the valid batch")
    MK.launches = 0
    t0 = time.perf_counter()
    ok, e2e_ms = events_ms(
        torch, lambda: api.batch_verify(msgs, sigs, pks, mode="adaptive"))
    e2e_host_s = time.perf_counter() - t0
    warm_launches = MK.launches
    if not ok.all():
        fail("warm adaptive run rejected the valid batch")
    stages = {
        "hash_ms": hash_ms, "weights_points_ms": points_ms,
        "miller_reduce_ms": miller_ms, "final_exp_is_one_ms": fe_ms,
        "e2e_adaptive_ms": e2e_ms, "verifies_per_s": B / (e2e_ms / 1e3),
        "montmul_launches_per_batch": warm_launches,
        "montmul_launches_per_verify": warm_launches / B,
        "sign_s": sign_s, "cold_adaptive_s": cold_s, "warm_host_s": e2e_host_s,
        "batch": B,
    }
    print(f"times on {card} (B={B}, warm, CUDA events): "
          + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                        for k, v in stages.items()}))

    # device busy share of one Miller doubling digit on the B+1 rows:
    # kernel time summed by the profiler over the digit's unprofiled wall time
    px, py = pts[0], pts[1]
    qx, qy = pts[2], pts[3]
    with torch.inference_mode():
        f0 = M._pin_fq12(T.fq12_one(px.batch_shape, dev))
        proj0 = M._pin_proj(M.ProjG2(qx, qy, T.fq2_one(px.batch_shape, dev)))

        def digit():
            f = T.fq12_sq(f0)
            _, line = M.dbl_step(proj0, px, py)
            return M.fq12_mul_line(f, *line)

        digit()
        torch.cuda.synchronize()
        t0_host = time.perf_counter()
        digit()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0_host) * 1e3
        from torch.profiler import ProfilerActivity, profile

        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            digit()
            torch.cuda.synchronize()
    dev_us = sum(getattr(e, "self_device_time_total",
                         getattr(e, "self_cuda_time_total", 0))
                 for e in prof.key_averages())
    n_ops = sum(e.count for e in prof.key_averages()
                if e.key.startswith("aten::"))
    stages["miller_digit_wall_ms"] = wall_ms
    stages["miller_digit_device_ms"] = dev_us / 1e3 if dev_us else None
    stages["miller_digit_busy_share"] = (
        dev_us / 1e3 / wall_ms if dev_us else None)
    stages["miller_digit_aten_ops"] = n_ops
    print(f"busy share, one Miller digit on {B + 1} rows: wall {wall_ms:.1f} ms, "
          f"device {stages['miller_digit_device_ms']} ms, "
          f"{n_ops} aten ops (profiler)")

    # kernel vs plain times at the widest main-path shape
    a_c, b_c = a_w.contiguous(), b_w.contiguous()
    _, k_ms = events_ms(torch, lambda: MK.montmul_cuda(a_c, b_c), reps=50)
    _, p_ms = events_ms(torch, lambda: MK.montmul_plain(a_c, b_c), reps=5)
    bytes_moved = 3 * NLIMBS * 8 * wide
    mads = 2 * NLIMBS * NLIMBS * wide
    t_bytes = bytes_moved / HBM_BYTES_PER_S * 1e3
    t_ops = mads / INT32_MAD_PER_S * 1e3
    kern = {
        "name": "montmul", "route": "cuda",
        "source": "bn254_tpu_torch/kernels/montmul.cu",
        "replaces": "bn254_tpu/kernels/montmul.py:50",
        "launches": main_launches, "max_abs_err": max_err,
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None,
    }
    print(card)
    print(json.dumps({"kernels": [kern]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
