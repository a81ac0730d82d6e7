#!/usr/bin/env python3
"""Smoke run of bn254_tpu_torch on one NVIDIA card (H100).

    python3 chip_smoke.py [--batch 8192] [--independent 4096] [--keys 16]
                          [--seed 2026] [--chunked 131072]
    python3 chip_smoke.py --nccl-world 4

(`--sharded-rank r --sharded-world n --sharded-port p --sharded-fixture f
--sharded-backend gloo|nccl` runs one rank of a sharded group; phase 10
and `--nccl-world` start them themselves.)

`--nccl-world n` runs none of the phases below: on n cards it builds phase
2's kernels, makes phase 8's first 16,384 tuples and phase 10's weights,
and starts n ranks of the sharded verifier over NCCL, a card each
(`mesh.initialize`'s default backend on cuda:rank), one-shot and in chunks
of 8,192: each must accept, accept and reject the last signature swapped
with exactly `sharded_launches`, and every rank's gathered Fq12 limbs must
be equal, and equal to the in-process product at the same partition. With
fewer than n cards it exits non-zero and runs nothing.

Phases, each of which exits non-zero on failure:

1. The card: name and power limit (nvidia-smi), torch and CUDA versions.
2. The kernel build: nvcc compiles bn254_tpu_torch/kernels/montmul.cu and
   fused.cu (with their shared header bn254_tower.cuh), one compiler per
   source, started together; build seconds and ptxas registers, stack and
   spills per kernel; for each instantiation of the lane-cooperative
   kernels (`fused.INSTANCES`: G = 4 ... 64 of miller_dbl_body, expu_step,
   miller_dbl_body2, miller_add_body2, fq12_mul, miller_add_body, expu_sq2,
   fq12_cyc_sq, fq12_mul_line, fq12_sq, g2_dbl_step, g2_add_step and g1_add,
   G = 1 ... 64 of glv_dbl_add), resident blocks per SM, shared memory per
   block, lanes per block, registers and stack
   (cudaOccupancyMaxActiveBlocksPerMultiprocessor and
   cudaFuncGetAttributes, through fused.cu's C exports), and the size each
   launcher's rule picks at the widths the paths run; the SASS instruction
   counts (cuobjdump, where the toolkit has it) of the kernels over the two
   leaves, cios and cios_wide (the pow windows and the cooperative
   schedules over cios_wide, miller_dbl_body's G=8 over cios). Then g++
   builds the native host core (host/native.py over csrc/bn254_host.cpp),
   with its seconds, before the first host scalar mul; it must be
   available.
3. Kernel vs plain.
   - montmul against its plain torch version, bit for bit, on random limbs
     at the main path's widest shape (54 x batch lanes), a lane count that is
     no multiple of the block, lazy boundary limbs, a broadcast operand, and
     an 8-lane sample against the Python-int Montgomery oracle.
   - The sixteen fused kernels of fused.cu against their plain bodies, run
     on the card with the plain leaf and no kernel inside, by canonical
     value, every output within the bounds the plain body declares, at the
     widths the paths give each (`WIDTHS`) and at 1 lane: random inputs at
     the pinned bounds (2^262, 2^16) with boundary lanes (the largest value
     with every low limb as large as the bound allows, the largest value
     carried, zero), a lane count that is no multiple of the 64-thread
     block, and an unbatched (18,) operand; the two-pair Miller bodies also
     with their constant line triple (ca, cb, cc) unbatched in its real
     place, between batched operands. The kernels with several threads per
     lane (all but the pow windows) are held so at every size they are
     built for, besides the path's own launch; glv_dbl_add also on the
     complete addition's edge lanes
     (acc, sel or both the identity, sel = 2acc, sel = -2acc) at the GLV
     ladder's width.
     Phase 6 adds every further lane count and input bound the paths
     launched a kernel at, and fails if a launch of phases 4 to 6 or 8 to 11
     is left unheld.
4. The main path through the user entry points: `api.batch_sign` makes
   the signatures of `batch` distinct messages under `keys` keys (8 held
   against the host oracle), then `api.batch_verify(mode="adaptive")`
   must accept all; `mode="fused"` must reject the batch with one
   signature swapped; `mode="adaptive"` on a tampered 64-tuple batch must
   flag exactly the tampered index, its independent fallback through the
   two-pair kernels (65 + 23 launches). Every kernel's launch count is
   reset just before the adaptive run and read just after: exactly 65
   miller_dbl_body, 23 miller_add_body, 69 expu_step, 24 expu_sq2, 64
   glv_dbl_add, 13 g1_add (a level of the signature tree-sum each), 200
   el_pow_step_mul and 51 el_pow_step_sq launches, none of
   the two-pair bodies, of fq12_sq (which this path runs only inside the
   Miller bodies) or of the scan loop's step ops, and some launches of
   montmul, fq12_mul and fq12_cyc_sq.
5. The independent tier at full width, the first `independent` (4,096)
   tuples of the main batch: `api.batch_verify(mode="independent")` runs
   pair2 (the JAX package's default) and must accept all, with exactly 65
   miller_dbl_body2, 23 miller_add_body2, 0 miller_dbl_body/_add_body, 69
   expu_step, 24 expu_sq2, 134 el_pow_step_mul, 33 el_pow_step_sq, 0
   glv_dbl_add and 0 g1_add launches, and one output template learned
   per two-pair body. With three signatures tampered it must flag exactly
   those, and so must the stacked form (the two pairs through the
   single-pair bodies, `pairing_check(*_independent_pairs(...))`, which the
   CPU takes).
   `api.batch_check_public_keys` on 64 key pairs, 3 of them mismatched,
   must return exactly the expected bools through 65 + 23 two-pair
   launches.
6. `config.unroll_static_loops=False` (`BN254_DISABLE_UNROLL`), set in
   `config.DEFAULT` for the phase: the adaptive run at `batch` must accept
   with exactly 65 fq12_sq, 65 g2_dbl_step, 23 g2_add_step and 88
   fq12_mul_line launches (the scan-form Miller loop), 193 fq12_cyc_sq and
   the default path's fq12_mul + 93 (exp_u's scan form), none of the
   unrolled-only kernels and some montmul (the powers and the GLV ladder
   leaf by leaf; the leaf launches of the loop's pins are counted); the
   swapped batch must be rejected, the tampered 64-tuple batch flagged at
   exactly its index (fused check and stacked fallback, 130/46/176/130
   step-op launches), the independent tier with three tampered flagged
   exactly through the stacked form at 2 x `independent` lanes, and the
   key check exact. Then, after the runs of phases 8 to 11, every fused
   kernel is held against its plain body, as in phase 3, at each further
   (lane count, input bounds) that the runs of phases 4 to 6 and 8 to 11
   launched it at
   (recorded by wrapping `fused.fused_op` and `fused._launch`); every
   (lane count, input bounds) a path launched must have been held so; the
   widths and bound sets held are printed for the kernels over cios_wide
   but glv_dbl_add (expu_sq2, fq12_cyc_sq, fq12_mul_line, fq12_sq,
   g2_dbl_step, g2_add_step and the two pow windows).
7. Times on a warm repeat (CUDA events), in both configurations: per stage
   (the weights stage also split into the GLV ladders and the signature
   tree-sum, the final exponentiation into its easy part, one exp_u, the
   hard part and is_one), end to end, the launch counts of a warm run (the
   same exact counts) and the montmul launches per verify; per kernel ms at
   its path's width beside its bound and its plain version, and the device
   busy share (profiler kernel time over wall time) of one miller_dbl_body
   launch and of one whole exp_u, the exp_u in both configurations in
   turns (default, unroll_static_loops=False, twice each, so that the scan
   form's exp_u stage is read against its own spread); the independent
   tier's verifies/s and its stages (hash, Miller, final exp) for pair2,
   the stacked form and the stacked form with unroll_static_loops=False, in
   turns; the kernels the
   independent tier shares with the adaptive path at the independent run's
   widths and launch counts; ms per launch (50 back to back, the better of
   two passes over the sizes) of every instantiation of the lane-
   cooperative kernels (the `coop_sweep` line): the Miller, exp_u and
   Fq12 bodies, the G2 steps and g1_add at 1 lane, 2, 4, 8 and 15 lanes per SM,
   `independent` and batch + 1 lanes, the four scan-loop kernels
   (fq12_mul_line, fq12_sq, g2_dbl_step, g2_add_step) also at every lane
   count the phase 6 runs launched them at (2 x `independent`, the tampered
   batch's fused check and stacked fallback); glv_dbl_add at 1 lane, 2
   lanes per SM, `independent`, batch + 1 and 2 x batch lanes; at one lane
   also each size's device time under torch.profiler. The busy shares count
   the profiler's kernel rows alone.
8. BASELINE config 5, `bench.py --chunks` (`bench_fused_chunked`): the
   chunked fused check, `dist/batch_verify.py:verify_batch_fused_chunked`,
   over `chunked` (131,072: config 5's 1,048,576 cut to 16 chunks for the
   script's time) tuples in chunks of 8,192, config 5's own (half the
   batch below 16,384 tuples, for a rehearsal at a few tuples). The
   fixture is made on the card as bench.py makes it: messages
   b"bench1m-%08d" % i, K=32 hash candidates (every message must hit),
   sk_i = ((0x1234567 + 977 i) mod 2^30) | 1, the signatures by
   `curve/g1.scalar_mul` of the hash points and the public keys by
   `curve/g2.scalar_mul` of the generator, 32-bit ladders, then affine;
   8 tuples of the first and last chunks are held against the host oracle.
   With 128-bit GLV weights the check must accept, with exactly
   `chunked_launches` fused launches (16 x each chunk's points and Miller
   stages, 15 one-lane fq12_mul folds, one final exponentiation) and some
   montmul; with the last chunk's last signature swapped it must reject; a
   chunk that does not divide the batch must raise InvalidLengthError. Its
   runs are recorded for phase 6's hold. Times (CUDA events, warm): the
   fixture's seconds, each chunk's ms (first, median, last), the final
   exponentiation, end to end, verifies/s, and the device memory the
   check takes beyond its inputs.
9. The protocol layer and the CLI (`python -m bn254_tpu_torch`) on the
   card. In this process: pubkey, sign, aggregate-pks, aggregate-sigs and
   verify on the reference's two example keys (the aggregate accepted on
   its message, rejected with rc 1 and FAIL on another) and hash-to-g1 of
   "sample" (the reference's golden value); then batch-verify on 256 JSON
   lines (16 keys, messages of three lengths, signed on the card by
   `api.batch_sign`, 8 of them byte-equal to `ECDSA.sign`'s, three
   signatures swapped) must exit 1 with FAIL on exactly those lines, its
   launches exactly `cli_launch_faults`' table (the independent tier
   through pair2, one square root per message length) and recorded for
   phase 6's hold; its ms (CUDA events) and api.batch_verify's alone. Each
   CLI step's calls into the native host core must be exactly
   `CLI_CORE_CALLS` (256 subgroup checks for the batch's keys). Then
   `python -m bn254_tpu_torch batch-verify` with no --device on 16 valid
   lines (rc 0, 16 ok lines) and `examples/batch_verify_gpu.py 16` (rc 0),
   each a process of its own, with their seconds.
10. The sharded verifier, `dist/batch_verify.py:make_sharded_verifier`,
   on the first 16,384 tuples of phase 8's fixture with 128-bit GLV
   weights from a seeded generator. (a) In this process, a world-size-1
   NCCL process group on the card: one-shot on 8,192 tuples and in 2
   chunks of 8,192 on 16,384, each accepting with `verify_batch_fused` /
   `verify_batch_fused_chunked` on the same inputs (the chunked runs with
   the same Miller product by canonical value), in chunks of 4,096 too,
   each with exactly `sharded_launches`; each rejecting its last
   signature swapped; a chunk that does not divide raising. Warm ms of
   the one-shot run against `verify_batch_fused`, in turns, and of one
   NCCL all_gather of the packed Fq12. (b) Two ranks on this card over
   gloo, each a process of this script (`--sharded-rank`, the fixture
   saved once with torch.save): 16,384 tuples one-shot (a shard of 8,192
   and its signature-sum row a rank) and in chunks of 8,192 (shards of
   4,096), both accepting, the swapped batch rejected, each rank's
   launches exactly `sharded_launches`, both ranks' gathered Fq12 limbs
   equal and equal to (a)'s in-process products by canonical value; each
   rank's wall seconds and gather-and-product ms. Every launch of (a) and
   (b) goes into phase 6's hold. Each rank has a time limit; a rank that
   fails fails the script.
11. The native host core (`host/native.py`): its build seconds and the
   calls of phase 9's steps; the core against the pure-Python oracle on
   seeded inputs (G1 and G2 muls at random scalars, 0, R and R + 5, a
   two-pair pairing product, a random twist point outside the subgroup);
   host ms in turns, core and oracle (BN254_DISABLE_NATIVE), of
   ECDSA.verify, 16 PublicKey.from_private_key and 256
   PublicKey.from_compressed, with exact core calls; the in-process CLI
   batch-verify again on the oracle and on the core.

It prints a kernels JSON line with every fused kernel on the path that
launches it (the lane-cooperative ones with their G at each width the
path runs them, `groups`), each with that path's name and launch count
(`adaptive`; the two-pair bodies `independent`; fq12_sq and the three step
ops `adaptive_no_unroll`) and its launches in phase 8's chunked run
(`chunked_launches`), in phase 9's CLI batch-verify
(`cli_batch_verify_launches`) and in each run of phase 10
(`sharded_launches`, by run; the gloo runs' from rank 0, which equal rank
1's), the shared kernels' rows for the independent path on
the line before the card's, and as its last line
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}.
"""

from __future__ import annotations

import argparse
import contextlib
import inspect
import io
import json
import pathlib
import re
import subprocess
import sys
import time

# H100 SXM peaks (NVIDIA data sheet): HBM3 at 3.35 TB/s; 67 TFLOP/s float32
# outside the tensor cores = 132 SMs x 128 FP32 lanes x 2 (FMA) x 1.98 GHz.
# Hopper has half as many INT32 lanes as FP32 lanes per SM, so its 32-bit
# integer multiply-add rate is 67e12 / 2 (lanes) / 2 (FMA counted once).
HBM_BYTES_PER_S = 3.35e12
INT32_MAD_PER_S = 67e12 / 4
LEAF_MADS = 2 * 18 * 18  # 32-bit multiply-adds of one CIOS leaf multiply

# the main path's launches of each fused kernel per batch: 65 NAF digits;
# 21 nonzero digits + 2 Frobenius steps; 3 exp_u x 23 nonzero / 8 zero
# windows; 64 steps of the GLV ladder (128-bit weights); the nonzero / zero
# 3-bit windows of the three fixed powers, the hash's square root ((p+1)/4:
# 68 / 15), the batched to_affine's and the easy part's inversions (p-2:
# 66 / 18 each). The other kernels' counts depend on the batch; they must
# be > 0, except those the path never runs (NOT_ON_MAIN_PATH, which must
# be 0).
MAIN_PATH_LAUNCHES = {"miller_dbl_body": 65, "miller_add_body": 23,
                      "expu_step": 69, "expu_sq2": 24, "glv_dbl_add": 64,
                      "el_pow_step_mul": 68 + 2 * 66,
                      "el_pow_step_sq": 15 + 2 * 18}
# the same batch by stage, as the chunked check (phase 8) runs them: the
# hash's square root; per chunk, the points stage (64 ladder steps, the
# signature tree-sum's levels over its tuples: `tree_launches`, the
# batched to_affine's inversion) and the Miller stage (65 + 23 digits, the
# product tree over its rows: `tree_launches`); once, the final
# exponentiation (three exp_u, fq12_inv's inversion, the easy part's 2,
# the exp_u tables' 3 and the hard part's 13 products, the tables' 3 and
# the hard part's 4 cyclotomic squares)
HASH_LAUNCHES = {"el_pow_step_mul": 68, "el_pow_step_sq": 15}
CHUNK_STAGE_LAUNCHES = {"glv_dbl_add": 64, "el_pow_step_mul": 66,
                        "el_pow_step_sq": 18, "miller_dbl_body": 65,
                        "miller_add_body": 23}
FINAL_EXP_LAUNCHES = {"expu_step": 69, "expu_sq2": 24, "el_pow_step_mul": 66,
                      "el_pow_step_sq": 18, "fq12_mul": 18, "fq12_cyc_sq": 7}


def tree_launches(rows: int) -> int:
    """Launches of a tree over `rows` rows, one a level (an odd row rides
    along): fq12_mul's 14 over the 8,193 Miller rows of 8,192 tuples,
    g1_add's 13 over their 8,192 signatures."""
    n = 0
    while rows > 1:
        rows, n = rows - rows // 2, n + 1
    return n


def staged(*tables) -> dict:
    out = {}
    for t in tables:
        for k, v in t.items():
            out[k] = out.get(k, 0) + v
    return out


assert {k: v for k, v in staged(HASH_LAUNCHES, CHUNK_STAGE_LAUNCHES,
                                FINAL_EXP_LAUNCHES).items()
        if k in MAIN_PATH_LAUNCHES} == MAIN_PATH_LAUNCHES


CONFIG5_CHUNK = 8192  # bench.py's config 5: 1,048,576 tuples in 128 chunks


def sharded_launches(world: int, n_chunks: int, shard_chunk: int) -> dict:
    """Every fused kernel's launches on one rank of `make_sharded_verifier`'s
    run over a mesh of `world` ranks, in n_chunks chunks whose shards are
    `shard_chunk` tuples: each chunk's stages at the shard's width, one
    one-lane fq12_mul fold per chunk after the first, world - 1 one-lane
    fq12_mul over the gathered values, one final exponentiation (the
    kernels the fused tier never runs are not named)."""
    per_chunk = {**CHUNK_STAGE_LAUNCHES,
                 "g1_add": tree_launches(shard_chunk),
                 "fq12_mul": tree_launches(shard_chunk + 1)}
    return staged({k: n_chunks * v for k, v in per_chunk.items()},
                  {"fq12_mul": n_chunks - 1 + world - 1}, FINAL_EXP_LAUNCHES)


def chunked_launches(n_chunks: int, chunk: int) -> dict:
    """Every fused kernel's launches in `verify_batch_fused_chunked` over
    n_chunks chunks of `chunk` tuples: a mesh of one rank's."""
    return sharded_launches(1, n_chunks, chunk)
# the independent tier on the card (pair2): the same schedule through the
# two-pair bodies, then the final exponentiation at one lane per tuple;
# one square root per message length (hash/tai_batch.py hashes each
# length's bucket on its own) and one inversion, no GLV ladder and no
# signature tree-sum
PAIR2 = ("miller_dbl_body2", "miller_add_body2")


def independent_launches(n_lengths: int = 1) -> dict:
    """The independent tier's fused launches over messages of `n_lengths`
    distinct lengths."""
    return {"miller_dbl_body2": 65, "miller_add_body2": 23,
            "miller_dbl_body": 0, "miller_add_body": 0,
            "expu_step": 69, "expu_sq2": 24,
            "el_pow_step_mul": 68 * n_lengths + 66,
            "el_pow_step_sq": 15 * n_lengths + 18, "glv_dbl_add": 0,
            "g1_add": 0}


INDEPENDENT_LAUNCHES = independent_launches(1)
# config.unroll_static_loops=False: the scan-form Miller loop, one launch
# per step op: 65 squares and doublings, 21 + 2 additions, a line fold after
# each of the 88 steps; exp_u's scan form adds 2 x 31 cyclotomic squares and
# 31 products per exp_u to the default path's counts; the kernels that only
# the unrolled forms and pair2 run stay at 0
SCAN_OPS = ("g2_dbl_step", "g2_add_step", "fq12_mul_line")
SCAN_MILLER_LAUNCHES = {"g2_dbl_step": 65, "g2_add_step": 23,
                        "fq12_mul_line": 88, "fq12_sq": 65}
UNROLLED_ONLY = ("miller_dbl_body", "miller_add_body", *PAIR2, "expu_step",
                 "expu_sq2", "el_pow_step_mul", "el_pow_step_sq",
                 "glv_dbl_add")
EXP_U_SCAN_EXTRA = {"fq12_cyc_sq": 3 * 62, "fq12_mul": 3 * 31}
NOT_ON_MAIN_PATH = {"fq12_sq", *PAIR2, *SCAN_OPS}  # fq12_sq: inside bodies


def cli_launch_faults(got: dict, n_lengths: int) -> list[str]:
    """How the fused launch counts `got` of one `python -m bn254_tpu_torch
    batch-verify` run (the independent tier through pair2) over messages of
    `n_lengths` lengths differ from its table: exact counts for the kernels
    of `independent_launches`, none of fq12_sq and the scan loop's step ops
    (scan form only), some of every other kernel (fq12_mul, fq12_cyc_sq)."""
    want = {**independent_launches(n_lengths),
            **dict.fromkeys(("fq12_sq", *SCAN_OPS), 0)}
    faults = [f"{k}: {got[k]} launches, want {v}" for k, v in want.items()
              if got[k] != v]
    return faults + [f"{k}: no launch" for k in got
                     if k not in want and not got[k]]


# phase 9: the reference's two example keys (examples/bn254.rs), the golden
# hash-to-G1 of "sample" (reference hash_test.rs), the CLI batch's lengths
CLI_KEYS = ("c9afa9d845ba75166b5c215767b1d6934e50c3db36e89b127b8a622b120f6721",
            "a55e93edb1350916bf5beea1b13d8f198ef410033445bcb645b65be5432722f1")
HASH_SAMPLE = ("0211e028f08c500889891cc294fe758a60e84495ec1e2d0bce208c9fc67b"
               "6486fd")
CLI_MSG_LENGTHS = (12, 24, 41)
# each CLI host step's calls into the native host core (host/native.py):
# a key derivation is one G2 mul, a signature one G1 mul (the hash stays
# pure Python, as in the JAX package), a compressed key's decode one
# subgroup check, a verify one pairing product; batch-verify decodes its
# lines' keys (one subgroup check a line)
CLI_CORE_CALLS = {"pubkey": {"g2_mul": 1}, "sign": {"g1_mul": 1},
                  "aggregate-pks": {"g2_in_subgroup": 2},
                  "aggregate-sigs": {}, "hash-to-g1": {},
                  "verify": {"g2_in_subgroup": 1, "pairing_product": 1}}


def calls_since(before: dict) -> dict:
    """The native host core's calls, by function, since the counts
    `before` (only those that rose)."""
    from bn254_tpu_torch.host import native as N

    return {k: v - before[k] for k, v in N.calls.items() if v != before[k]}


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


def reset_counts():
    """Every kernel's launch count to 0."""
    from bn254_tpu_torch.kernels import fused as FK
    from bn254_tpu_torch.kernels import montmul as MK

    MK.launches = 0
    FK.launches.update(dict.fromkeys(FK.launches, 0))


def lanes(recorded):
    """The lane counts of each key's recorded launches."""
    return {k: sorted({n for n, _ in v}) for k, v in recorded.items()}


def in_bounds(args_):
    """The (vmax, lmax) of every El of a fused kernel's arguments."""
    from bn254_tpu_torch.fields import limbs as L

    return tuple((e.vmax, e.lmax) for e in L.tree_leaves(args_))


@contextlib.contextmanager
def launches_recorded(*into):
    """Each fused kernel launch's (lane count, input bounds), added to
    every dict of `into` under its key."""
    from bn254_tpu_torch.kernels import fused as FK

    fused_op, launch = FK.fused_op, FK._launch
    bounds = [None]  # the bounds of the fused_op call that launches

    def recorded_op(fn, key, *args_):
        bounds[0] = in_bounds(args_)
        return fused_op(fn, key, *args_)

    def recorded(key, packed, out):
        for d in into:
            d.setdefault(key, set()).add((packed.shape[2], bounds[0]))
        return launch(key, packed, out)

    FK.fused_op, FK._launch = recorded_op, recorded
    try:
        yield
    finally:
        FK.fused_op, FK._launch = fused_op, launch


@contextlib.contextmanager
def final_exp_inputs(into: list):
    """The Fq12 each final exponentiation is given (the Miller product of
    a fused or sharded check), appended to `into`."""
    from bn254_tpu_torch.pairing import final_exp as FE

    final_exp = FE.final_exp

    def recorded(f):
        into.append(f)
        return final_exp(f)

    FE.final_exp = recorded
    try:
        yield
    finally:
        FE.final_exp = final_exp


def fq12_canon(packed) -> list[int]:
    """The twelve canonical Fp values (Montgomery form, mod p) of an Fq12
    packed by `dist.collectives.pack` (a tensor or a list of 216 limbs)."""
    import torch

    from bn254_tpu_torch.constants import NLIMBS, P
    from bn254_tpu_torch.fields import limbs as L

    t = torch.as_tensor(packed).reshape(12, NLIMBS).T.cpu()
    return [int(v) % P for v in L.to_ints(t)]


def config5_fixture(NC: int, CH: int, dev):
    """bench.py's config-5 fixture (`bench_fused_chunked`), the first NC
    tuples made on the card in chunks of CH: messages b"bench1m-%08d" % i,
    K=32 hash candidates (every message must hit), sk_i = ((0x1234567 +
    977 i) mod 2^30) | 1, the signatures by the G1 ladder of the hash
    points and the keys by the G2 ladder of the generator (32 bits), then
    affine; 8 tuples of the first and last chunks held against the host
    oracle. Returns ((hx, hy, sx, sy, qx, qy), each chunk's hash ms, the
    seconds, the held indices)."""
    import numpy as np
    import torch

    from bn254_tpu_torch.curve import g1 as DG1
    from bn254_tpu_torch.curve import g2 as DG2
    from bn254_tpu_torch.curve import jacobian as J
    from bn254_tpu_torch.fields import limbs as L
    from bn254_tpu_torch.fields import tower as T
    from bn254_tpu_torch.hash import tai_batch as TB
    from bn254_tpu_torch.hash.tai import hash_to_g1
    from bn254_tpu_torch.host import curve as HC
    from bn254_tpu_torch.utils import convert as CV

    K5, slab = 32, 8 * CH

    def cat_els(els):
        return L.El(torch.cat([e.arr for e in els], dim=-1),
                    max(e.vmax for e in els), max(e.lmax for e in els))

    def host_ints(e, idx):
        return [int(v) for v in L.to_ints(L.from_mont(
            L.El(e.arr[:, idx], e.vmax, e.lmax)))]

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    msgs5 = [b"bench1m-%08d" % i for i in range(NC)]
    blocks5, ctr_word, ctr_shift = TB.prepare_blocks_host(msgs5)
    blocks5 = torch.from_numpy(blocks5.astype(np.int64)).to(dev)
    sk5 = [((0x1234567 + 977 * i) % (1 << 30)) | 1 for i in range(NC)]
    cols = []  # per slab: hx, hy, sx, sy, pk x (Fq2), pk y (Fq2)
    hash_ms = []  # each chunk's hash (bench.py's timed region has it)
    for off in range(0, NC, slab):
        hs = []
        for c in range(off, min(off + slab, NC), CH):
            (hx, hy, found, _), ms = events_ms(
                torch, lambda: TB.hash_to_g1_batch(
                    blocks5[c:c + CH], ctr_word, ctr_shift, K5))
            hash_ms.append(ms)
            if not bool(found.all()):
                fail(f"chunked fixture: a hash miss in chunk {c // CH}")
            hs.append((hx, hy))
        hx, hy = (cat_els([h[i] for h in hs]) for i in range(2))
        n = hx.batch_shape[-1]
        sk = CV.scalars_to_device(sk5[off:off + n], dev)
        sx, sy, inf_s = DG1.to_affine(DG1.scalar_mul(
            J.JPoint(hx, hy, L.mont_one((n,), dev)), sk, 32))
        qx, qy, inf_q = DG2.to_affine(DG2.scalar_mul(
            DG2.generator((n,), dev), sk, 32))
        if bool(inf_s.any()) or bool(inf_q.any()):
            fail("chunked fixture: an identity signature or key")
        cols.append((hx, hy, sx, sy, qx, qy))
    hx5, hy5, sx5, sy5 = (cat_els([c[i] for c in cols]) for i in range(4))
    qx5, qy5 = (T.Fq2(cat_els([c[i].c0 for c in cols]),
                      cat_els([c[i].c1 for c in cols])) for i in (4, 5))
    del cols, hs, blocks5
    torch.cuda.synchronize()
    fixture_s = time.perf_counter() - t0
    sample = [0, 1, CH // 2, CH - 1, NC - CH, NC - CH + 1, NC - 2, NC - 1]
    got_h = list(zip(host_ints(hx5, sample), host_ints(hy5, sample)))
    got_s = list(zip(host_ints(sx5, sample), host_ints(sy5, sample)))
    got_q = list(zip(zip(host_ints(qx5.c0, sample),
                         host_ints(qx5.c1, sample)),
                     zip(host_ints(qy5.c0, sample),
                         host_ints(qy5.c1, sample))))
    for j, i in enumerate(sample):
        h = hash_to_g1(msgs5[i])
        if (got_h[j] != HC.g1_to_affine(h)
                or got_s[j] != HC.g1_to_affine(HC.g1_mul(h, sk5[i]))
                or got_q[j] != HC.g2_to_affine(
                    HC.g2_mul(HC.G2_ONE, sk5[i]))):
            fail(f"chunked fixture: tuple {i} disagrees with the host "
                 "oracle")
    return (hx5, hy5, sx5, sy5, qx5, qy5), hash_ms, fixture_s, sample


def ptxas_summary(log: str) -> list[str]:
    """Registers, stack frame and spills of each kernel entry in a
    `-Xptxas=-v` report."""
    out, entry = [], None
    props = {}
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, "
                      r"(\d+) bytes spill loads", line)
        if m and entry:
            props[entry] = m.groups()
            continue
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry and "kernel" in entry:
            stack, st, ld = props.get(entry, ("?", "?", "?"))
            short = kernel_name(entry)
            out.append(f"{short}: {m.group(1)} registers, {stack} B stack "
                       f"frame, {st} B spill stores, {ld} B spill loads")
    return out


def kernel_name(mangled: str) -> str:
    """coop_kernel<Sched, G>, <name>_kernel<T> or <name>_kernel."""
    coop = re.search(r"coop_kernelIN5bn254\d+(\w+?)ELi(\d+)E", mangled)
    if coop:
        return f"coop_kernel<{coop.group(1)}, {coop.group(2)}>"
    tmpl = re.search(r"^_Z\d+(\w+_kernel)ILi(\d+)E", mangled)
    if tmpl:
        return f"{tmpl.group(1)}<{tmpl.group(2)}>"
    return re.sub(r"^_Z\w*?\d+(\w+_kernel)\w*$", r"\1", mangled)


def sass_counts(nvcc: str, lib_path: str, wanted) -> list[str]:
    """Instructions per kernel of a library's SASS (cuobjdump -sass, from
    nvcc's toolkit; a kernel's listing holds the device functions it calls),
    for the kernels whose short name `wanted` accepts: the total and the ten
    commonest opcodes."""
    tool = pathlib.Path(nvcc).with_name("cuobjdump")
    if not tool.is_file():
        return [f"cuobjdump not found beside {nvcc}"]
    r = subprocess.run([str(tool), "-sass", lib_path], capture_output=True,
                       text=True, timeout=300)
    if r.returncode != 0:
        return [f"cuobjdump failed: {r.stderr.strip()[:200]}"]
    counts, fn = {}, None
    for line in r.stdout.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            fn = kernel_name(m.group(1))
            counts[fn] = {} if wanted(fn) else None
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][\w.]*)",
                      line)
        if m and fn and counts.get(fn) is not None:
            counts[fn][m.group(1)] = counts[fn].get(m.group(1), 0) + 1
    return [f"{fn}: {sum(c.values())} instructions, "
            + json.dumps(dict(sorted(c.items(), key=lambda kv: -kv[1])[:10]))
            for fn, c in counts.items() if c]


SHARDED_TUPLES = 2 * CONFIG5_CHUNK  # phase 10: the first 16,384 of phase 8
SHARDED_TIMEOUT_S = 300  # phase 10b: a rank's collectives and its process


def sharded_worker(args) -> int:
    """One rank of phase 10b (gloo, the ranks on one card) or of the
    `--nccl-world` mode (NCCL, a card a rank): `make_sharded_verifier` over
    the `--sharded-backend` group of `--sharded-world` ranks, on the full
    batch saved in
    `--sharded-fixture`: one-shot, in chunks, and with the last signature
    swapped, each with its launch counts and (lane count, input bounds);
    then the gather-and-product alone. Prints one SHARDED-RESULT JSON line
    for the parent, with the gathered Fq12's packed limbs."""
    t_start = time.perf_counter()
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    try:
        import torch.distributed as dist

        from bn254_tpu_torch.curve.glv import GlvWeights
        from bn254_tpu_torch.dist import batch_verify as BV
        from bn254_tpu_torch.dist import collectives as COLL
        from bn254_tpu_torch.dist import mesh as MESH
        from bn254_tpu_torch.fields import limbs as L
        from bn254_tpu_torch.fields import tower as T
        from bn254_tpu_torch.kernels import build
        from bn254_tpu_torch.kernels import fused as FK
        from bn254_tpu_torch.kernels import montmul as MK
    except ImportError as e:
        print(f"chip_smoke: the bn254_tpu_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 3
    rank, world = args.sharded_rank, args.sharded_world
    backend = args.sharded_backend
    if not all(build._output(n).exists() for n in ("montmul", "fused")):
        fail(f"rank {rank}: the kernels are not built (phase 2 builds them "
             "before the ranks start; a rank starts no nvcc)")
    # NCCL: initialize's default backend on cuda:rank; gloo: asked for,
    # so that several ranks share one card
    if not MESH.initialize(coordinator_address=f"127.0.0.1:{args.sharded_port}",
                           num_processes=world, process_id=rank,
                           backend=None if backend == "nccl" else "gloo",
                           timeout=SHARDED_TIMEOUT_S):
        fail(f"rank {rank}: no process group was started")
    try:
        mesh = MESH.make_mesh()
        if (mesh.size, mesh.rank, mesh.backend, mesh.device) != (
                world, rank, backend,
                torch.device("cuda", rank % torch.cuda.device_count())):
            fail(f"rank {rank}: mesh {mesh}")
        fx = torch.load(args.sharded_fixture, map_location=mesh.device,
                        weights_only=True)
        els = [L.El(a, *b) for a, b in zip(fx["arrs"], fx["bounds"])]
        xs = (*els[:4], T.Fq2(*els[4:6]), T.Fq2(*els[6:8]))
        w = GlvWeights(L.El(fx["wa"], *fx["w_bounds"]),
                       L.El(fx["wb"], *fx["w_bounds"]), fx["bits"])
        run = BV.make_sharded_verifier(mesh)
        widths, launches, products, seconds = {}, {}, {}, {}

        def timed(tag, xs_, chunk):
            reset_counts()
            seen = []
            t0 = time.perf_counter()
            with launches_recorded(widths), final_exp_inputs(seen):
                ok = bool(run(*xs_, w, chunk=chunk))
            seconds[tag] = time.perf_counter() - t0
            launches[tag] = {**FK.launches, "montmul": MK.launches}
            products[tag] = seen[0]
            return ok

        ok_one = timed("oneshot", xs, None)
        ok_chunked = timed("chunked", xs, fx["chunk"])
        hx, hy, sx, sy, qx, qy = xs
        with torch.inference_mode():
            bad_sx, bad_sy = (L.El(e.arr.clone(), e.vmax, e.lmax)
                              for e in (sx, sy))
            bad_sx.arr[:, -1], bad_sy.arr[:, -1] = sx.arr[:, -2], sy.arr[:, -2]
        ok_swapped = timed("swapped", (hx, hy, bad_sx, bad_sy, qx, qy), None)
        with torch.inference_mode():  # the gather and the product alone
            f = products["oneshot"]
            COLL.fq12_allreduce_mul(f, mesh)
            _, gather_ms = events_ms(
                torch, lambda: COLL.fq12_allreduce_mul(f, mesh), reps=20)
        print("SHARDED-RESULT " + json.dumps({
            "rank": rank, "world": world, "oneshot_ok": ok_one,
            "chunked_ok": ok_chunked, "swapped_ok": ok_swapped,
            "launches": launches,
            "products": {k: COLL.pack(products[k]).tolist()
                         for k in ("oneshot", "chunked")},
            "widths": {k: sorted([n, [list(b) for b in bounds]]
                                 for n, bounds in v)
                       for k, v in widths.items()},
            "seconds": seconds, "gather_product_ms": gather_ms,
            "wall_s": time.perf_counter() - t_start}), flush=True)
    finally:
        dist.destroy_process_group()
    return 0


def sharded_weights(n: int, seed: int, dev):
    """Phase 10's 128-bit GLV weights for n tuples from a seeded generator
    (the first (1, 0))."""
    import random

    from bn254_tpu_torch.curve import glv as GLV

    wrng = random.Random(seed)
    return GLV.glv_weights_to_device(
        [(1, 0)] + [(wrng.getrandbits(64), wrng.getrandbits(64))
                    for _ in range(n - 1)], 128, dev)


def sharded_ranks(world: int, backend: str, full, w, chunk: int,
                  products: dict, run_launches: dict, widths: dict):
    """`world` processes of this script (`sharded_worker`, one rank each,
    over `backend`) on the full batch `full` with weights `w`, saved once
    with torch.save: one-shot, in chunks of `chunk` and with the last
    signature swapped. Each rank must accept, accept and reject, with
    exactly `sharded_launches` for its shards; all ranks' gathered Fq12
    limbs must be equal, and equal by canonical value to `products` (the
    in-process Miller product at the matching partition, by "oneshot" and
    "chunked"). Each launch's (lane count, input bounds) goes into
    `run_launches` and `widths`. Returns (each rank's SHARDED-RESULT,
    the ranks' wall seconds)."""
    import socket
    import tempfile

    import torch

    from bn254_tpu_torch.dist import collectives as COLL
    from bn254_tpu_torch.fields import limbs as L
    from bn254_tpu_torch.kernels import fused as FK

    n = full[0].batch_shape[-1]
    shard = n // world
    with tempfile.TemporaryDirectory() as tmp:
        fixture = pathlib.Path(tmp) / "sharded_fixture.pt"
        leaves = L.tree_leaves(full)
        torch.save({"arrs": [e.arr.cpu() for e in leaves],
                    "bounds": [(e.vmax, e.lmax) for e in leaves],
                    "wa": w.a.arr.cpu(), "wb": w.b.arr.cpu(),
                    "w_bounds": (w.a.vmax, w.a.lmax), "bits": w.bits,
                    "chunk": chunk}, fixture)
        with socket.socket() as sock:
            sock.bind(("127.0.0.1", 0))
            port = sock.getsockname()[1]
        root = pathlib.Path(__file__).resolve().parent
        t0 = time.perf_counter()
        procs = [subprocess.Popen(
            [sys.executable, str(root / "chip_smoke.py"), "--sharded-rank",
             str(r), "--sharded-world", str(world), "--sharded-port",
             str(port), "--sharded-fixture", str(fixture),
             "--sharded-backend", backend],
            cwd=root, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True) for r in range(world)]
        outs = []
        try:
            for p in procs:
                outs.append(p.communicate(timeout=SHARDED_TIMEOUT_S))
        except subprocess.TimeoutExpired:
            fail(f"sharded ranks ({backend}, world {world}): a rank did not "
                 f"finish in {SHARDED_TIMEOUT_S} s")
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        ranks_s = time.perf_counter() - t0
    who = f"sharded ranks ({backend}, world {world})"
    results = []
    for r, (p, (out, err)) in enumerate(zip(procs, outs)):
        lines_ = [x for x in out.splitlines()
                  if x.startswith("SHARDED-RESULT ")]
        if p.returncode != 0 or len(lines_) != 1:
            fail(f"{who}: rank {r} rc {p.returncode}, stdout "
                 f"{out[-600:]!r}, stderr {err[-1500:]!r}")
        results.append(json.loads(lines_[0][len("SHARDED-RESULT "):]))
    want = {"oneshot": sharded_launches(world, 1, shard),
            "chunked": sharded_launches(world, n // chunk,
                                        chunk // world)}
    want["swapped"] = want["oneshot"]
    for r, res in enumerate(results):
        if (res["rank"], res["world"]) != (r, world) or not res["oneshot_ok"] \
                or not res["chunked_ok"] or res["swapped_ok"]:
            fail(f"{who}: rank {r} accepted {res['oneshot_ok']} "
                 f"(one-shot) / {res['chunked_ok']} (chunks of {chunk}), "
                 f"{res['swapped_ok']} with the last signature swapped")
        for tag, want_t in want.items():
            got = res["launches"][tag]
            if {k: got[k] for k in FK.KERNELS} != {
                    **dict.fromkeys(FK.KERNELS, 0), **want_t} \
                    or not got["montmul"]:
                fail(f"{who}: rank {r}'s {tag} launches "
                     f"{json.dumps(got)}, want {json.dumps(want_t)}")
        for key, seen in res["widths"].items():
            for n, bounds in seen:
                for d in (run_launches, widths):
                    d.setdefault(key, set()).add(
                        (n, tuple(tuple(b) for b in bounds)))
    for tag, f_in in products.items():
        limbs = [res["products"][tag] for res in results]
        if any(x != limbs[0] for x in limbs) or fq12_canon(
                limbs[0]) != fq12_canon(COLL.pack(f_in)):
            fail(f"{who}: the ranks' {tag} products differ from each "
                 "other or from the in-process product at the same "
                 "partition")
    return results, ranks_s


def sharded_phase(args, card: str, inputs, run_launches: dict) -> dict:
    """Phase 10: `make_sharded_verifier` on the first SHARDED_TUPLES
    (16,384) tuples of `inputs` (phase 8's fixture) with 128-bit GLV
    weights from a seeded generator: (a) in this process over NCCL at world
    size 1, against the one-device checks; (b) two ranks on this card over
    gloo, each a process of this script (`sharded_worker`), against (a)'s
    in-process products. Every launch's (lane count, input bounds) goes
    into `run_launches` for the final hold; returns each run's launches."""
    import datetime

    import torch
    import torch.distributed as dist

    from bn254_tpu_torch.dist import batch_verify as BV
    from bn254_tpu_torch.dist import collectives as COLL
    from bn254_tpu_torch.dist import mesh as MESH
    from bn254_tpu_torch.errors import InvalidLengthError
    from bn254_tpu_torch.fields import limbs as L
    from bn254_tpu_torch.kernels import fused as FK
    from bn254_tpu_torch.kernels import montmul as MK

    dev = torch.device("cuda", 0)

    t10 = time.perf_counter()
    NS = min(SHARDED_TUPLES, inputs[0].batch_shape[-1])
    C10 = NS // 2  # the one-shot batch and the chunk
    w10 = sharded_weights(NS, args.seed, dev)

    def first(n, xs):
        return tuple(BV._slice_batch(x, slice(0, n)) for x in xs)

    def swapped_last(xs):
        """The tuples with the last signature replaced by the one before."""
        hx, hy, sx, sy, qx, qy = xs
        with torch.inference_mode():
            bsx, bsy = (L.El(e.arr.clone(), e.vmax, e.lmax) for e in (sx, sy))
            bsx.arr[:, -1], bsy.arr[:, -1] = sx.arr[:, -2], sy.arr[:, -2]
        return hx, hy, bsx, bsy, qx, qy

    full10 = first(NS, inputs)
    half10, w_half = first(C10, full10), BV._slice_batch(w10, slice(0, C10))
    sharded_widths = {}  # the (lanes, bounds) of this phase's launches
    sharded_counts = {}  # each run's launches, by run

    def counted_run(tag, run, xs, w, chunk, want):
        """(accepted, the final exponentiation's input) of one sharded run,
        whose fused launches must be exactly `want` (and some montmul)."""
        seen = []
        reset_counts()
        with launches_recorded(run_launches, sharded_widths), \
                final_exp_inputs(seen):
            ok = bool(run(*xs, w, chunk=chunk))
        got = {**FK.launches, "montmul": MK.launches}
        if {k: got[k] for k in FK.KERNELS} != {
                **dict.fromkeys(FK.KERNELS, 0), **want} or not MK.launches:
            fail(f"sharded {tag}: launches {json.dumps(got)}, want "
                 f"{json.dumps(want)} and some montmul")
        sharded_counts[tag] = got
        return ok, seen[0]

    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1, timeout=datetime.timedelta(
                                seconds=SHARDED_TIMEOUT_S))
    try:
        mesh = MESH.make_mesh()
        if (mesh.size, mesh.rank, mesh.backend, mesh.device) != (
                1, 0, "nccl", dev):
            fail(f"sharded: the NCCL mesh is {mesh}")
        run = BV.make_sharded_verifier(mesh)
        ok_a, _ = counted_run(f"nccl_world1_{C10}", run, half10, w_half,
                              None, sharded_launches(1, 1, C10))
        ok_ref = bool(BV.verify_batch_fused(*half10, w_half))
        if not (ok_a and ok_ref):
            fail(f"sharded one-shot {C10} (NCCL, world 1): {ok_a}, "
                 f"verify_batch_fused {ok_ref}; want both to accept")
        ok_b, f_b = counted_run(f"nccl_world1_{NS}_chunk{C10}", run, full10,
                                w10, C10, sharded_launches(1, 2, C10))
        ref_seen = []
        with final_exp_inputs(ref_seen):
            ok_ref = bool(BV.verify_batch_fused_chunked(*full10, w10,
                                                        chunk=C10))
        if not (ok_b and ok_ref) or fq12_canon(COLL.pack(f_b)) != fq12_canon(
                COLL.pack(ref_seen[0])):
            fail(f"sharded chunked {NS} in {C10} (NCCL, world 1): {ok_b}, "
                 f"verify_batch_fused_chunked {ok_ref}; want both to accept "
                 "with the same Miller product")
        # the chunk 10b's ranks run: each rank's shard of a chunk of C10
        ok_c, f_c = counted_run(f"nccl_world1_{NS}_chunk{C10 // 2}", run,
                                full10, w10, C10 // 2,
                                sharded_launches(1, 4, C10 // 2))
        if not ok_c:
            fail(f"sharded chunked {NS} in {C10 // 2} (NCCL, world 1) "
                 "rejected a valid batch")
        with launches_recorded(run_launches, sharded_widths):
            if bool(run(*swapped_last(half10), w_half)) or bool(run(
                    *swapped_last(full10), w10, chunk=C10)):
                fail("sharded (NCCL, world 1) accepted a batch with its last "
                     "signature swapped")
        try:
            run(*full10, w10, chunk=C10 + 1)
            fail(f"sharded: a chunk of {C10 + 1} for {NS} tuples did not "
                 "raise")
        except InvalidLengthError:
            pass
        turns = {"verify_batch_fused": [], "sharded": []}
        for form in ("verify_batch_fused", "sharded", "sharded",
                     "verify_batch_fused"):
            ok, ms = events_ms(torch, (
                (lambda: BV.verify_batch_fused(*half10, w_half))
                if form == "verify_batch_fused"
                else (lambda: run(*half10, w_half))))
            if not bool(ok):
                fail(f"a warm {form} run rejected the valid batch")
            turns[form].append(ms)
        packed = COLL.pack(f_b)
        COLL.all_gather(packed, mesh)  # warm: NCCL makes its communicator
        _, gather_ms = events_ms(torch, lambda: COLL.all_gather(packed, mesh),
                                 reps=20)
    finally:
        dist.destroy_process_group()
    print(f"sharded 10a (NCCL, world size 1, {card}): one-shot {C10} "
          f"accepts with verify_batch_fused; {NS} in chunks of {C10} accepts "
          "with verify_batch_fused_chunked, the same Miller product by "
          f"canonical value; in chunks of {C10 // 2} accepts; both reject the "
          f"last signature swapped; a chunk of {C10 + 1} raises; launches "
          f"{json.dumps(sharded_counts)}; warm ms in turns (CUDA events) "
          f"{json.dumps(turns)}; one NCCL all_gather of the packed Fq12 "
          f"({packed.numel() * 8} bytes) {gather_ms:.4f} ms")

    # 10b: two ranks on this card over gloo, each a process of this script
    results, ranks_s = sharded_ranks(2, "gloo", full10, w10, C10,
                                     {"oneshot": f_b, "chunked": f_c},
                                     run_launches, sharded_widths)
    for tag in ("oneshot", "chunked", "swapped"):
        sharded_counts[f"gloo_world2_{tag}"] = results[0]["launches"][tag]
    print(f"sharded 10b (gloo, 2 ranks on {card}): {NS} tuples one-shot "
          f"(a shard of {C10}) and in chunks of {C10} (shards of {C10 // 2}) "
          "accepted, the last signature swapped rejected, on both ranks; "
          "the same gathered Fq12 limbs on both, equal to the in-process "
          "product by canonical value; launches exact; " + json.dumps({
              "ranks_wall_s": ranks_s,
              "rank_wall_s": [res["wall_s"] for res in results],
              "rank_run_s": [res["seconds"] for res in results],
              "gather_product_ms": [res["gather_product_ms"]
                                    for res in results]})
          + f"; lanes per launch {json.dumps(lanes(sharded_widths))}; phase "
          f"10 in {time.perf_counter() - t10:.1f} s wall")
    return sharded_counts


def host_core_phase(card: str, seed: int, build_s: float, phase9_calls: dict,
                    cli_ms: float, cli_batch_verify) -> dict:
    """Phase 11: the native host core (host/native.py over
    csrc/bn254_host.cpp). It must be available; the calls of phase 9's CLI
    steps are printed; the core is held against the pure-Python oracle
    (`g1_mul_py`, `g2_mul_py`, `pairing_batch_py`, `jac_scalar_mul(., R)`)
    on seeded inputs: G1 and G2 scalar muls at random scalars, 0, R and
    R + 5, a two-pair pairing product, a random twist point outside the
    subgroup. Then host ms in turns (core, oracle, core, oracle; the
    oracle under BN254_DISABLE_NATIVE) of ECDSA.verify, 16
    PublicKey.from_private_key and 256 PublicKey.from_compressed, each
    turn's results equal and its core calls exact; and the in-process CLI
    batch-verify of phase 9 on the oracle, then on the core again
    (`cli_batch_verify`), beside phase 9's `cli_ms`. Returns the times."""
    import os
    import random

    from bn254_tpu_torch import ECDSA, PrivateKey, PublicKey
    from bn254_tpu_torch.constants import P, R
    from bn254_tpu_torch.host import curve as HC
    from bn254_tpu_torch.host import field as HF
    from bn254_tpu_torch.host import native as N
    from bn254_tpu_torch.host import pairing as HP

    t11 = time.perf_counter()
    if not N.available():
        fail("host core: not available (BN254_DISABLE_NATIVE set, or no C++ "
             "compiler)")
    print(f"host core: {N.output().name}, built in {build_s:.2f} s (phase "
          f"2); calls a CLI step in phase 9 {json.dumps(phase9_calls)}; "
          f"calls of the run so far {json.dumps(N.calls)}")

    # held against the oracle on seeded inputs
    rng = random.Random(seed)
    before = dict(N.calls)
    ks = [rng.randrange(R), rng.randrange(R), 0, R, R + 5]
    g1 = HC.g1_mul_py(HC.G1_ONE, rng.randrange(1, R))
    g2 = HC.g2_mul_py(HC.G2_ONE, rng.randrange(1, R))
    for k in ks:
        if HC.g1_to_affine(HC.g1_mul(g1, k)) != HC.g1_to_affine(
                HC.g1_mul_py(g1, k)) or HC.g2_to_affine(HC.g2_mul(
                    g2, k)) != HC.g2_to_affine(HC.g2_mul_py(g2, k)):
            fail(f"host core: a scalar mul by {k} differs from the oracle")
    pairs = [(HC.g1_mul_py(HC.G1_ONE, rng.randrange(1, R)),
              HC.g2_mul_py(HC.G2_ONE, rng.randrange(1, R))) for _ in range(2)]
    if not HF.fq12_eq(HP.pairing_batch(pairs), HP.pairing_batch_py(pairs)):
        fail("host core: the two-pair pairing product differs from the oracle")
    while True:  # a random point of the twist, almost surely outside G2
        x = (rng.randrange(P), rng.randrange(P))
        y = HF.fq2_sqrt(HF.fq2_add(HF.fq2_mul(HF.fq2_sq(x), x), HC.B2))
        if y is not None:
            break
    if HC.g2_is_in_subgroup((x, y)) or HC.jac_is_identity(HC.jac_scalar_mul(
            HC.g2_from_affine((x, y)), R, HC.FQ2_OPS), HC.FQ2_OPS):
        fail("host core: a random twist point was reported in the subgroup")
    held = calls_since(before)
    if held != {"g1_mul": len(ks), "g2_mul": len(ks), "pairing_product": 1,
                "g2_in_subgroup": 1}:
        fail(f"host core: the holds' calls into the core {held}")
    print(f"host core: equal to the oracle on G1 and G2 muls by {len(ks)} "
          "scalars (random, 0, R, R + 5), a two-pair pairing product, and a "
          f"random twist point outside the subgroup; calls {json.dumps(held)}")

    @contextlib.contextmanager
    def path(form):
        if form == "oracle":
            os.environ["BN254_DISABLE_NATIVE"] = "1"
        try:
            yield
        finally:
            os.environ.pop("BN254_DISABLE_NATIVE", None)

    sks = [PrivateKey(rng.randrange(1, R)) for _ in range(16)]
    pk0 = PublicKey.from_private_key(sks[0])
    sig0 = ECDSA.sign(b"host-core", sks[0])
    encoded = [PublicKey.from_private_key(k).to_compressed() for k in sks]
    ops = {  # name: (fn, its calls into the core)
        "verify": (lambda: ECDSA.verify(b"host-core", sig0, pk0),
                   {"pairing_product": 1}),
        "from_private_key_16": (lambda: [
            PublicKey.from_private_key(k).to_compressed() for k in sks],
            {"g2_mul": 16}),
        "from_compressed_256": (lambda: [
            PublicKey.from_compressed(encoded[i % 16]).to_compressed()
            for i in range(256)], {"g2_in_subgroup": 256}),
    }
    times = {}
    for name, (fn, want) in ops.items():
        times[name] = {"core": [], "oracle": []}
        outs = []
        for form in ("core", "oracle", "core", "oracle"):
            before = dict(N.calls)
            with path(form):
                t0 = time.perf_counter()
                outs.append(fn())
                times[name][form].append((time.perf_counter() - t0) * 1e3)
            got = calls_since(before)
            if got != (want if form == "core" else {}):
                fail(f"host core: {name} on the {form} called the core "
                     f"{got}")
        if any(o != outs[0] for o in outs):
            fail(f"host core: {name} differs between the core and the oracle")
    cli = {"core": [cli_ms], "oracle": []}
    for form in ("oracle", "core"):
        with path(form):
            ms, got = cli_batch_verify()
        if got != ({"g2_in_subgroup": 256} if form == "core" else {}):
            fail(f"host core: the CLI batch-verify on the {form} called the "
                 f"core {got}")
        cli[form].append(ms)
    times["cli_batch_verify_256"] = cli
    times["phase_s"] = time.perf_counter() - t11
    print(f"host core on {card}: host ms in turns (core, oracle, core, "
          "oracle; the CLI's in-process 256-line batch-verify: phase 9's "
          "core run, then oracle, core) " + json.dumps(times))
    return times


def nccl_world(args) -> int:
    """`--nccl-world n`: the sharded verifier over NCCL, n ranks, a card
    each. Builds phase 2's kernels, makes phase 8's first SHARDED_TUPLES
    (16,384) tuples and phase 10's weights on cuda:0, and computes the
    in-process Miller products at the partitions the ranks run
    (`verify_batch_fused_chunked` in chunks of one shard); then n processes
    of this script (`sharded_worker`, each `mesh.initialize` with its
    default backend, NCCL on cuda:rank) must each accept one-shot and in
    chunks of 8,192 and reject the last signature swapped, with exactly
    `sharded_launches`, and gather the same Fq12 limbs, equal to the
    in-process products. With fewer than n cards it runs nothing and exits
    non-zero: it falls back neither to gloo nor to fewer ranks."""
    t_start = time.perf_counter()
    import torch

    world = args.nccl_world
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    cards = torch.cuda.device_count()
    if world < 2 or cards < world:
        print(f"chip_smoke: --nccl-world {world} needs {max(world, 2)} cards, "
              f"one a rank; this machine has {cards}", file=sys.stderr)
        return 2
    try:
        from bn254_tpu_torch.dist import batch_verify as BV
        from bn254_tpu_torch.kernels import build
    except ImportError as e:
        print(f"chip_smoke: the bn254_tpu_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 3
    card = card_line()
    print(card)
    print(f"cards: {cards} | torch {torch.__version__} | CUDA "
          f"{torch.version.cuda} | NCCL "
          f"{'.'.join(map(str, torch.cuda.nccl.version()))}")
    t0 = time.perf_counter()
    try:
        build.build(["montmul", "fused"])
    except build.KernelBuildError as e:
        fail(str(e))
    print(f"build: montmul.cu and fused.cu in {time.perf_counter() - t0:.2f} "
          "s wall")
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    NS = SHARDED_TUPLES
    with torch.inference_mode():
        full, _, fixture_s, sample = config5_fixture(NS, CONFIG5_CHUNK, dev)
        w = sharded_weights(NS, args.seed, dev)
        products = {}
        for tag, c in (("oneshot", NS // world),
                       ("chunked", CONFIG5_CHUNK // world)):
            seen = []
            with final_exp_inputs(seen):
                if not bool(BV.verify_batch_fused_chunked(*full, w, chunk=c)):
                    fail(f"verify_batch_fused_chunked in chunks of {c} "
                         "rejected the valid batch")
            products[tag] = seen[0]
    print(f"nccl fixture: {NS} tuples on cuda:0 in {fixture_s:.2f} s, tuples "
          f"{sample} agree with the host oracle; in-process products in "
          f"chunks of {NS // world} and {CONFIG5_CHUNK // world}")
    results, ranks_s = sharded_ranks(world, "nccl", full, w, CONFIG5_CHUNK,
                                     products, {}, {})
    print(f"nccl world {world} ({cards} x {card}): {NS} tuples one-shot "
          f"(shards of {NS // world}) and in chunks of {CONFIG5_CHUNK} "
          f"(shards of {CONFIG5_CHUNK // world}) accepted, the last signature "
          "swapped rejected, on every rank; launches exact; the same "
          "gathered Fq12 limbs on every rank, equal to the in-process "
          "products by canonical value")
    print(json.dumps({"nccl_world": world, "cards": cards, "card": card,
                      "ranks_wall_s": ranks_s,
                      "rank_wall_s": [r["wall_s"] for r in results],
                      "rank_run_s": [r["seconds"] for r in results],
                      "gather_product_ms": [r["gather_product_ms"]
                                            for r in results],
                      "launches_rank0": results[0]["launches"],
                      "wall_s": time.perf_counter() - t_start}))
    return 0


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=8192)
    ap.add_argument("--independent", type=int, default=4096,
                    help="tuples of the independent-tier phase (at most "
                         "--batch)")
    ap.add_argument("--keys", type=int, default=16)
    ap.add_argument("--seed", type=int, default=2026)
    ap.add_argument("--chunked", type=int, default=16 * CONFIG5_CHUNK,
                    help="tuples of the chunked config-5 phase, in chunks of "
                         "8,192 (BASELINE config 5 runs 1,048,576)")
    ap.add_argument("--nccl-world", type=int, default=None,
                    help="instead of the phases: the sharded verifier over "
                         "NCCL with this many ranks, a card each (needs as "
                         "many cards), and exit")
    ap.add_argument("--sharded-rank", type=int, default=None,
                    help="run as this rank of a sharded group (started by "
                         "phase 10 or --nccl-world itself) and exit")
    ap.add_argument("--sharded-world", type=int, default=2)
    ap.add_argument("--sharded-port", type=int, default=0)
    ap.add_argument("--sharded-fixture", default=None)
    ap.add_argument("--sharded-backend", choices=("gloo", "nccl"),
                    default="gloo")
    args = ap.parse_args()
    if args.sharded_rank is not None:
        return sharded_worker(args)
    if args.nccl_world is not None:
        return nccl_world(args)
    t_start = time.perf_counter()
    chunk = min(CONFIG5_CHUNK, args.chunked // 2)
    if chunk < 1 or args.chunked % chunk:
        print(f"chip_smoke: --chunked must be a multiple of {CONFIG5_CHUNK}",
              file=sys.stderr)
        return 2

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only",
              file=sys.stderr)
        return 2
    try:
        from bn254_tpu_torch import api
        from bn254_tpu_torch import config as C
        from bn254_tpu_torch.constants import MONT_R, NLIMBS, P, R
        from bn254_tpu_torch.curve import jacobian as J
        from bn254_tpu_torch.curve.ops import FqOps
        from bn254_tpu_torch.dist import batch_verify as BV
        from bn254_tpu_torch.errors import InvalidLengthError
        from bn254_tpu_torch.fields import limbs as L
        from bn254_tpu_torch.fields import tower as T
        from bn254_tpu_torch.hash.tai import hash_to_g1
        from bn254_tpu_torch.hash.tai_batch import hash_to_g1_device
        from bn254_tpu_torch.host import curve as HC
        from bn254_tpu_torch.host import native as NATIVE
        from bn254_tpu_torch.kernels import build
        from bn254_tpu_torch.kernels import fused as FK
        from bn254_tpu_torch.kernels import montmul as MK
        from bn254_tpu_torch.pairing import final_exp as FE
        from bn254_tpu_torch.pairing import miller as M
        from bn254_tpu_torch.pairing import pairing as DP
        from bn254_tpu_torch.utils import convert as CV
        from bn254_tpu_torch.utils import samples as SM
    except ImportError as e:
        print(f"chip_smoke: the bn254_tpu_torch package is missing ({e}); "
              "run from the root of the repository", file=sys.stderr)
        return 3

    dev = torch.device("cuda")
    B = args.batch
    NI = min(args.independent, B)

    # -- 1. the card ---------------------------------------------------------
    card = card_line()
    name = torch.cuda.get_device_name(0)
    print(card)
    print(f"card: {card} | torch {torch.__version__} | CUDA {torch.version.cuda}"
          f" | python {sys.version.split()[0]}")

    # -- 2. the kernel build (one nvcc per source, started together) ------------
    t0 = time.perf_counter()
    try:
        build.build(["montmul", "fused"])
        for lib in ("montmul", "fused"):
            build.library(lib)
    except build.KernelBuildError as e:
        fail(str(e))
    nvcc = build.nvcc()
    ver = subprocess.run([nvcc, "--version"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(f"build: {nvcc} ({ver[-1] if ver else '?'}) montmul.cu and fused.cu "
          f"in {time.perf_counter() - t0:.2f} s wall")
    for lib in ("montmul", "fused"):
        for line in ptxas_summary(build.build_log.get(lib, "")):
            print(f"build: ptxas: {line}")
    # the native host core (host/native.py over csrc/bn254_host.cpp), before
    # the first host scalar mul of the fixtures
    t0 = time.perf_counter()
    try:
        NATIVE.library()
    except build.KernelBuildError as e:
        fail(str(e))
    core_build_s = time.perf_counter() - t0
    if not NATIVE.available():
        fail("the native host core is not available (BN254_DISABLE_NATIVE "
             "set, or no C++ compiler)")
    print(f"build: the native host core {NATIVE.output().name} "
          f"({NATIVE.compiler()}, {' '.join(NATIVE.CXX_FLAGS)}) in "
          f"{core_build_s:.2f} s wall")
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    K = C.DEFAULT.k_candidates

    for key, sizes in FK.INSTANCES.items():
        for g in sizes:
            print(f"build: {key} G={g}: "
                  + json.dumps(FK.coop_info(key, g)))
        print(f"build: {key}'s rule on {sms} SMs picks "
              f"{list(FK.coop_groups(key))}: " + json.dumps(
                  {n: FK.coop_group(key, n, sms)
                   for n in (1, NI, 2 * NI, B + 1, 2 * B, NI * K, B * K)}))
    # the kernels over cios_wide, and over cios for comparison
    for line in sass_counts(nvcc, str(build._output("fused")), lambda fn: (
            fn.startswith(("el_pow_step_", "coop_kernel<CoopGlvDblAdd",
                           "coop_kernel<CoopMillerDblBody, 8>",
                           "coop_kernel<CoopExpuSq2",
                           "coop_kernel<CoopFq12CycSq",
                           "coop_kernel<CoopFq12MulLine",
                           "coop_kernel<CoopFq12Sq",
                           "coop_kernel<CoopG2DblStep",
                           "coop_kernel<CoopG2AddStep")))):
        print(f"build: sass: {line}")

    # -- 3. kernel vs plain ----------------------------------------------------
    gen = torch.Generator(device="cpu").manual_seed(args.seed)

    def rand_limbs(n, top_bits=7):
        """Lazy limbs < 2^16, top limb < 2^top_bits: value < 2^(255+top)."""
        x = torch.randint(0, 1 << 16, (NLIMBS, n), generator=gen, dtype=torch.int64)
        x[NLIMBS - 1] = torch.randint(0, 1 << top_bits, (n,), generator=gen)
        return x.to(dev)

    max_err = {k: 0 for k in ["montmul", *FK.KERNELS]}
    checked = {k: set() for k in FK.KERNELS}  # (lanes, input bounds) compared

    def check(tag, a, b):
        got = MK.montmul_cuda(a, b)
        want = MK.montmul_plain(a, b)
        torch.cuda.synchronize()
        err = int((got - want).abs().max().item()) if got.numel() else 0
        max_err["montmul"] = max(max_err["montmul"], err)
        if not torch.equal(got, want):
            fail(f"montmul kernel differs from plain on {tag}: max |err| {err}")
        print(f"kernel vs plain: montmul: {tag}: {tuple(got.shape)} bit-exact")
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
    print("kernel vs oracle: montmul: 8 lanes agree by value")

    @contextlib.contextmanager
    def plain_leaf(count=None):
        """Plain bodies run with the plain torch leaf and no kernel inside
        (kernel mode); with `count`, the products of the function per lane
        are tallied in it. The leaves of `limbs.vreduce` are left out: they
        only squeeze the plain body's lazy value bounds (the kernels keep
        every Fp below 2p with conditional adds and subtracts instead)."""
        saved, saved_vreduce = MK.montmul, L.vreduce
        squeezing = [False]

        def leaf(a, b):
            if count is not None and not squeezing[0]:
                count[0] += torch.broadcast_tensors(a, b)[0].numel() // NLIMBS
            return MK.montmul_plain(a, b)

        def vreduce(a):
            squeezing[0] = True
            try:
                return saved_vreduce(a)
            finally:
                squeezing[0] = False

        MK.montmul, L.vreduce = leaf, vreduce
        try:
            with FK.kernel_mode():
                yield
        finally:
            MK.montmul, L.vreduce = saved, saved_vreduce

    # each kernel's widest main-path width: the B+1 Miller rows (the
    # unrolled bodies, or the scan form's step ops and line folds); the
    # first level of the Fq12 product tree; the one-lane final
    # exponentiation; the hash's B x k square roots; the (H, sig) pair axis
    # of the GLV ladder; the first level of the signature tree-sum; the
    # two-pair bodies at one lane per tuple of the
    # independent tier
    WIDTHS = {"miller_dbl_body": B + 1, "miller_add_body": B + 1,
              "miller_dbl_body2": NI, "miller_add_body2": NI,
              "expu_step": 1, "expu_sq2": 1, "fq12_mul": (B + 1) // 2,
              "fq12_sq": B + 1, "fq12_cyc_sq": 1, "el_pow_step_mul": B * K,
              "el_pow_step_sq": B * K, "glv_dbl_add": 2 * B,
              "g1_add": max(1, B // 2), **dict.fromkeys(SCAN_OPS, B + 1)}
    rng = np.random.default_rng(args.seed)
    PINS = (L.STD_BOUND, 1 << 16)

    def body_inputs(key, n, unbatched=(), bounds=None):
        """Random inputs on n lanes, boundary lanes first, each El within
        its (vmax, lmax) of `bounds` (default: all at the pins, (2^262,
        2^16)); the arguments named in `unbatched` as (18,) Els."""
        n_in = FK.arity(key)[0]
        args_ = FK.args_from_leaves(key, [
            CV.from_numpy(SM.bounded_limbs(rng, vm, lm, n), vm, lm, dev)
            for vm, lm in (bounds or (PINS,) * n_in)])
        names = inspect.signature(FK.signature(key)[0]).parameters
        return tuple(
            L.tree_map(lambda e: L.El(e.arr[:, 0], e.vmax, e.lmax), a)
            if name in unbatched else a for name, a in zip(names, args_))

    def glv_edge_inputs(n):
        """glv_dbl_add's inputs on n lanes at the pins, lanes 0-4 the
        complete addition's edges: acc the identity, sel the identity,
        both (random X and Y: the last select wins); sel = 2acc (the
        doubling select), sel = -2acc (the identity)."""
        x = np.stack([SM.bounded_limbs(rng, *PINS, n) for _ in range(6)])
        x[2, :, 0] = 0  # acc.z
        x[5, :, 1] = 0  # sel.z
        x[[0, 1, 3, 4], :, 2] = SM.bounded_limbs(rng, *PINS, 8)[:, 4:].T
        d = J.double(FqOps, J.JPoint(*[CV.from_numpy(x[i, :, 3:5], *PINS)
                                       for i in range(3)]))
        d2 = [L.canon(e).arr.numpy() for e in (d.x, d.y, d.z)]
        neg_y = L.canon(L.neg_mod(d.y)).arr.numpy()
        for i in range(3):
            x[3 + i, :, 3] = d2[i][:, 0]
            x[3 + i, :, 4] = (d2[0], neg_y, d2[2])[i][:, 1]
        return FK.args_from_leaves("glv_dbl_add", [
            CV.from_numpy(e, *PINS, dev) for e in x])

    def with_group(key, args_, group):
        """`fused_op`'s CUDA path with the kernel of `key` launched at
        `group` threads per lane (not counted)."""
        body = FK.signature(key)[0]
        template = FK._out_struct(body, in_bounds(args_), args_)
        packed, batch = FK.pack(L.tree_leaves(args_))
        out = torch.empty((FK.arity(key)[1], NLIMBS, packed.shape[2]),
                          dtype=torch.int64, device=dev)
        if packed.shape[2]:
            FK.launch_group(key, packed, out, group)
        rows = iter(out)
        return L.tree_map(lambda t: L.El(
            next(rows).reshape((NLIMBS,) + batch), t.vmax, t.lmax), template)

    def compare(key, tag, args_):
        body = FK.signature(key)[0]
        gots = {"": FK.fused_op(body, key, *args_)}
        for g in FK.INSTANCES.get(key, ()):
            gots[f" at G={g}"] = with_group(key, args_, g)
        with plain_leaf():
            want = body(*args_)
        torch.cuda.synchronize()
        wl = L.tree_leaves(want)
        for how, got in gots.items():
            gl = L.tree_leaves(got)
            err = 0
            for g, w in zip(gl, wl):
                if (g.vmax, g.lmax) != (w.vmax, w.lmax):
                    fail(f"{key}: learned bounds differ from the plain body's")
                if int(g.arr.min()) < 0 or int(g.arr.max()) >= g.lmax:
                    fail(f"{key}{how} on {tag}: a limb is outside "
                         f"[0, {g.lmax})")
                if not bool(L.lt_const(g, g.vmax).all()):
                    fail(f"{key}{how} on {tag}: a value is not below its "
                         "declared bound")
                cg, cw = L.canon(g).arr, L.canon(w).arr
                err = max(err, int((cg - cw).abs().max()) if cg.numel() else 0)
            max_err[key] = max(max_err[key], err)
            if err:
                fail(f"{key}{how} differs from its plain body on {tag} by value")
        checked[key].add((gl[0].arr[0].numel(), in_bounds(args_)))
        shape = tuple(gl[0].arr.shape)
        groups = (f" (the path's launch and G = {list(FK.INSTANCES[key])})"
                  if key in FK.INSTANCES else "")
        print(f"kernel vs plain: {key}: {tag}: {len(gl)} x {shape} equal by "
              f"canonical value, within the declared bounds{groups}")

    with torch.inference_mode():
        for key in FK.KERNELS:
            n = WIDTHS[key]
            compare(key, f"random + boundary lanes, {n} lanes",
                    body_inputs(key, n))
            if n != 1:
                compare(key, "1 lane", body_inputs(key, 1))
            compare(key, "70 lanes (no multiple of 64)", body_inputs(key, 70))
            names = tuple(inspect.signature(FK.signature(key)[0]).parameters)
            if len(names) > 1:
                compare(key, "an unbatched (18,) last operand",
                        body_inputs(key, 77, unbatched=names[-1:]))
            else:
                compare(key, "an unbatched (18,) operand",
                        body_inputs(key, 1, unbatched=names))
            if key in PAIR2:
                compare(key, "the constant line (ca, cb, cc) unbatched (18,) "
                        f"between batched operands, {NI} lanes",
                        body_inputs(key, NI, unbatched=("ca", "cb", "cc")))
            if key == "glv_dbl_add":
                compare(key, "the complete addition's five edge lanes "
                        f"first, {n} lanes", glv_edge_inputs(n))

    # -- 4. the main path --------------------------------------------------------
    main_want = {**MAIN_PATH_LAUNCHES, "g1_add": tree_launches(B)}

    def check_counts(tag):
        got = dict(FK.launches)
        exact = {k: got[k] for k in main_want}
        if exact != main_want:
            fail(f"{tag}: fused kernel launches {exact}, want {main_want}")
        idle = [k for k, v in got.items() if not v and k not in
                NOT_ON_MAIN_PATH]
        if idle or MK.launches == 0:
            fail(f"{tag}: the main path launched no {idle or 'montmul'} kernel")
        if any(got[k] for k in NOT_ON_MAIN_PATH):
            fail(f"{tag}: unexpected launches of {sorted(NOT_ON_MAIN_PATH)}")
        return {**got, "montmul": MK.launches}

    # (lane count, input bounds) of every fused launch of the runs below
    run_launches = {}

    def check_pair2_counts(tag, want=INDEPENDENT_LAUNCHES):
        got = {k: FK.launches[k] for k in want}
        if got != want:
            fail(f"{tag}: fused kernel launches {got}, want {want}")
        return {**FK.launches, "montmul": MK.launches}

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

    main_widths = {}  # the (lanes, bounds) of the main path's launches
    reset_counts()
    with launches_recorded(run_launches, main_widths):
        t0 = time.perf_counter()
        ok = api.batch_verify(msgs, sigs, pks, mode="adaptive")
        torch.cuda.synchronize()
        cold_s = time.perf_counter() - t0
    main_launches = check_counts("cold adaptive run")
    if ok.shape != (B,) or not ok.all():
        fail(f"adaptive rejected a valid batch: {int((~ok).sum())} false")
    print(f"verify adaptive B={B}: all {B} valid, {cold_s:.2f} s cold, "
          f"launches {json.dumps(main_launches)}")

    swapped = list(sigs)
    swapped[B // 3] = sigs[B // 3 + 1]
    if api.batch_verify(msgs, swapped, pks, mode="fused"):
        fail("fused accepted a batch with a swapped signature")
    print("verify fused: rejects the batch with one signature swapped")

    small, bad_i = min(64, B), min(17, B - 1)
    tampered = list(sigs[:small])
    tampered[bad_i] = api.Signature(HC.g1_mul(sigs[bad_i].point, 2))
    reset_counts()
    with launches_recorded(run_launches):
        ok64 = api.batch_verify(msgs[:small], tampered, pks[:small],
                                mode="adaptive")
    if ok64.tolist() != [i != bad_i for i in range(small)]:
        fail(f"adaptive B={small} flagged {np.flatnonzero(~ok64).tolist()}, "
             f"want [{bad_i}]")
    # the fused pre-check, then the independent fallback through pair2
    check_pair2_counts(f"adaptive B={small} tampered", {
        "miller_dbl_body": 65, "miller_add_body": 23,
        "miller_dbl_body2": 65, "miller_add_body2": 23})
    print(f"verify adaptive B={small}: exactly index {bad_i} rejected, the "
          "fallback through 65 + 23 two-pair kernel launches")

    # -- 5. the independent tier (pair2) at full width ---------------------------
    msgs_i, sigs_i, pks_i = msgs[:NI], sigs[:NI], pks[:NI]
    ind_widths = {}  # the (lanes, bounds) of the independent run's launches
    reset_counts()
    with launches_recorded(ind_widths, run_launches):
        t0 = time.perf_counter()
        ok = api.batch_verify(msgs_i, sigs_i, pks_i, mode="independent")
        torch.cuda.synchronize()
        ind_cold_s = time.perf_counter() - t0
    ind_launches = check_pair2_counts("independent run")
    if ok.shape != (NI,) or not ok.all():
        fail(f"independent rejected a valid batch: {int((~ok).sum())} false")
    for body in (M._dbl_body2_impl, M._add_body2_impl):
        n_tpl = sum(fn is body for fn, _ in FK._out_structs)
        if n_tpl != 1:
            fail(f"{body.__name__} learned {n_tpl} output templates, want 1")
    print(f"verify independent B={NI} (pair2): all {NI} valid, "
          f"{ind_cold_s:.2f} s cold, launches {json.dumps(ind_launches)}; "
          "one output template per two-pair body; lanes per launch "
          + json.dumps(lanes(ind_widths)))

    bad = sorted({min(5, NI - 1), NI // 2, NI - 1})
    tampered_i = list(sigs_i)
    for i in bad:
        tampered_i[i] = api.Signature(HC.g1_mul(sigs_i[i].point, 2))
    ok_t = api.batch_verify(msgs_i, tampered_i, pks_i, mode="independent")
    if np.flatnonzero(~ok_t).tolist() != bad:
        fail(f"independent flagged {np.flatnonzero(~ok_t).tolist()}, "
             f"want {bad}")

    def device_tuples(msgs_, sigs_, pks_):
        """(hx, hy, sx, sy, pqx, pqy) on the card, as api.batch_verify
        makes them."""
        return (*hash_to_g1_device(msgs_, None, dev),
                *CV.g1_batch_to_device_affine([s.point for s in sigs_], dev),
                *CV.g2_batch_to_device_affine([k.point for k in pks_], dev))

    def stacked_check(msgs_, sigs_, pks_):
        """The independent tier's stacked form: the two pairs through the
        single-pair bodies, the pair-axis product, the final exp."""
        with torch.inference_mode():
            return DP.pairing_check(*BV._independent_pairs(
                *device_tuples(msgs_, sigs_, pks_))).cpu().numpy()

    reset_counts()
    ok_s = stacked_check(msgs_i, tampered_i, pks_i)
    check_pair2_counts("stacked independent run", {
        "miller_dbl_body2": 0, "miller_add_body2": 0,
        "miller_dbl_body": 65, "miller_add_body": 23})
    if ok_s.tolist() != ok_t.tolist():
        fail("the stacked independent form disagrees with pair2: flags "
             f"{np.flatnonzero(~ok_s).tolist()}")
    print(f"verify independent B={NI}: exactly {bad} rejected by pair2 and "
          "by the stacked form")

    n_pk, bad_pk = min(64, B), [3, 31, 60]
    bad_pk = [i for i in bad_pk if i < n_pk]
    pk_sks = [int.from_bytes(rng.bytes(32), "big") % R for _ in range(n_pk)]
    pk2s = [Key(HC.g2_mul(HC.G2_ONE, k)) for k in pk_sks]
    pk1s = [Key(HC.g1_mul(HC.G1_ONE, k + (i in bad_pk)))
            for i, k in enumerate(pk_sks)]
    reset_counts()
    with launches_recorded(run_launches):
        ok_pk = api.batch_check_public_keys(pk2s, pk1s)
    check_pair2_counts("batch_check_public_keys", {
        "miller_dbl_body2": 65, "miller_add_body2": 23,
        "miller_dbl_body": 0, "miller_add_body": 0})
    if ok_pk.tolist() != [i not in bad_pk for i in range(n_pk)]:
        fail(f"batch_check_public_keys flagged "
             f"{np.flatnonzero(~ok_pk).tolist()}, want {bad_pk}")
    print(f"batch_check_public_keys: {n_pk} key pairs, exactly {bad_pk} "
          "mismatched, through 65 + 23 two-pair kernel launches")

    # -- 6. config.unroll_static_loops=False -------------------------------------
    @contextlib.contextmanager
    def no_unroll():
        """config.DEFAULT with the loops in their scan forms (the dispatch
        sites read config.DEFAULT), restored after."""
        saved = C.DEFAULT
        C.DEFAULT = saved.replace(unroll_static_loops=False)
        try:
            yield
        finally:
            C.DEFAULT = saved

    def check_scan_counts(tag, want):
        """Exact counts of `want`, none of the unrolled-only kernels, some
        montmul."""
        got = {**FK.launches, "montmul": MK.launches}
        want = {**dict.fromkeys(UNROLLED_ONLY, 0), **want}
        if {k: got[k] for k in want} != want or not got["montmul"]:
            fail(f"{tag}: launches {json.dumps(got)}, want "
                 f"{json.dumps(want)} and some montmul")
        return got

    scan_widths = {}  # the (lanes, bounds) of the launches of this phase
    pin_leaves = [0]  # the leaf multiplies launched by the Miller loop's pins

    @contextlib.contextmanager
    def pin_leaves_counted():
        pin_el = M._pin_el

        def counted(e):
            pin_leaves[0] += e.vmax > L.STD_BOUND  # one vreduce leaf launch
            return pin_el(e)

        M._pin_el = counted
        try:
            yield
        finally:
            M._pin_el = pin_el

    scan_want = {**SCAN_MILLER_LAUNCHES, **{
        k: main_launches[k] + v for k, v in EXP_U_SCAN_EXTRA.items()}}
    nu = "unroll_static_loops=False"
    with no_unroll():
        reset_counts()
        with launches_recorded(run_launches, scan_widths), \
                pin_leaves_counted():
            t0 = time.perf_counter()
            ok = api.batch_verify(msgs, sigs, pks, mode="adaptive")
            torch.cuda.synchronize()
            scan_cold_s = time.perf_counter() - t0
        scan_launches = check_scan_counts(f"cold adaptive run, {nu}",
                                          scan_want)
        if ok.shape != (B,) or not ok.all():
            fail(f"adaptive ({nu}) rejected a valid batch: "
                 f"{int((~ok).sum())} false")
        print(f"verify adaptive B={B}, {nu}: all {B} valid, "
              f"{scan_cold_s:.2f} s cold, launches "
              f"{json.dumps(scan_launches)}; {pin_leaves[0]} of the montmul "
              "launches are the Miller loop's pins")

        if api.batch_verify(msgs, swapped, pks, mode="fused"):
            fail(f"fused ({nu}) accepted a batch with a swapped signature")
        print(f"verify fused, {nu}: rejects the batch with one signature "
              "swapped")

        reset_counts()
        with launches_recorded(run_launches, scan_widths):
            ok64 = api.batch_verify(msgs[:small], tampered, pks[:small],
                                    mode="adaptive")
        if ok64.tolist() != [i != bad_i for i in range(small)]:
            fail(f"adaptive B={small} ({nu}) flagged "
                 f"{np.flatnonzero(~ok64).tolist()}, want [{bad_i}]")
        # the fused pre-check, then the stacked independent fallback
        check_scan_counts(f"adaptive B={small} tampered, {nu}", {
            k: 2 * v for k, v in SCAN_MILLER_LAUNCHES.items()})
        print(f"verify adaptive B={small}, {nu}: exactly index {bad_i} "
              "rejected, the fused check and the stacked fallback through "
              + json.dumps({k: 2 * v for k, v in SCAN_MILLER_LAUNCHES.items()})
              + " step-op launches")

        scan_ind = {}
        reset_counts()
        with launches_recorded(scan_ind, run_launches, scan_widths):
            ok_t = api.batch_verify(msgs_i, tampered_i, pks_i,
                                    mode="independent")
        check_scan_counts(f"independent run, {nu}", SCAN_MILLER_LAUNCHES)
        if np.flatnonzero(~ok_t).tolist() != bad:
            fail(f"independent ({nu}) flagged "
                 f"{np.flatnonzero(~ok_t).tolist()}, want {bad}")
        if lanes(scan_ind)["g2_dbl_step"] != [2 * NI]:
            fail(f"independent ({nu}): the step ops ran at "
                 f"{lanes(scan_ind)['g2_dbl_step']} lanes, want {2 * NI}")
        print(f"verify independent B={NI}, {nu}: exactly {bad} rejected by "
              f"the stacked form at {2 * NI} lanes; lanes per launch "
              + json.dumps(lanes(scan_ind)))

        reset_counts()
        with launches_recorded(run_launches, scan_widths):
            ok_pk = api.batch_check_public_keys(pk2s, pk1s)
        check_scan_counts(f"batch_check_public_keys, {nu}",
                          SCAN_MILLER_LAUNCHES)
        if ok_pk.tolist() != [i not in bad_pk for i in range(n_pk)]:
            fail(f"batch_check_public_keys ({nu}) flagged "
                 f"{np.flatnonzero(~ok_pk).tolist()}, want {bad_pk}")
        print(f"batch_check_public_keys, {nu}: {n_pk} key pairs, exactly "
              f"{bad_pk} mismatched, through the stacked form")

    # -- 8. the chunked config-5 path ----------------------------------------------
    # bench.py's config 5 (`bench_fused_chunked`): 1,048,576 tuples in chunks
    # of 8,192 on one chip, cut to --chunked tuples; the fixture made on the
    # card as bench.py makes it (K=32 hash candidates, sk_i small odd ints,
    # signatures and public keys by the device ladders, 32 bits)
    NC, CH = args.chunked, chunk
    n_ch = NC // CH

    chunked_widths = {}  # the (lanes, bounds) of this phase's launches
    with torch.inference_mode(), \
            launches_recorded(run_launches, chunked_widths):
        inputs5, hash_ms, fixture_s, sample = config5_fixture(NC, CH, dev)
        hx5, hy5, sx5, sy5, qx5, qy5 = inputs5
        print(f"chunked fixture: {NC} tuples ({n_ch} chunks of {CH}; "
              f"config 5's 1,048,576 cut to {NC}) made on the card in "
              f"{fixture_s:.2f} s, K=32; tuples {sample} agree with the "
              "host oracle")

        w5 = BV.random_weights(NC, 128, dev)
        reset_counts()
        torch.cuda.reset_peak_memory_stats()
        held_mb = torch.cuda.memory_allocated() / 2**20
        t0 = time.perf_counter()
        ok5 = bool(BV.verify_batch_fused_chunked(*inputs5, w5, chunk=CH))
        chunked_cold_s = time.perf_counter() - t0
        peak_mb = torch.cuda.max_memory_allocated() / 2**20 - held_mb
        chunk_launches = {**FK.launches, "montmul": MK.launches}
        want5 = {**dict.fromkeys(FK.KERNELS, 0),
                 **chunked_launches(n_ch, CH)}
        if {k: chunk_launches[k] for k in FK.KERNELS} != want5 \
                or not MK.launches:
            fail(f"chunked run: launches {json.dumps(chunk_launches)}, "
                 f"want {json.dumps(want5)} and some montmul")
        if not ok5:
            fail(f"the chunked check rejected {NC} valid tuples")
        print(f"verify chunked B={NC} in {n_ch} chunks of {CH} (128-bit GLV "
              f"weights): accepts, {chunked_cold_s:.2f} s cold, "
              f"{peak_mb:.1f} MiB of device memory beyond the "
              f"{held_mb:.1f} MiB held, launches "
              + json.dumps(chunk_launches))

        bad_sx, bad_sy = (L.El(e.arr.clone(), e.vmax, e.lmax)
                          for e in (sx5, sy5))
        bad_sx.arr[:, -1], bad_sy.arr[:, -1] = sx5.arr[:, -2], sy5.arr[:, -2]
        if bool(BV.verify_batch_fused_chunked(
                hx5, hy5, bad_sx, bad_sy, qx5, qy5, w5, chunk=CH)):
            fail("the chunked check accepted a batch with a signature of "
                 "its last chunk swapped")
        del bad_sx, bad_sy
        bad_chunk = next(c for c in (CH + 1, CH - 1, 3 * CH // 2) if NC % c)
        try:
            BV.verify_batch_fused_chunked(*inputs5, w5, chunk=bad_chunk)
            fail(f"a chunk of {bad_chunk} for {NC} tuples did not raise")
        except InvalidLengthError:
            pass
        print(f"verify chunked B={NC}: rejects the batch with the last "
              f"chunk's last signature swapped; a chunk of {bad_chunk} "
              "raises InvalidLengthError")

    # -- 9. the protocol layer and the CLI on the card -------------------------------
    t9 = time.perf_counter()
    from bn254_tpu_torch import ECDSA, PrivateKey, PublicKey
    from bn254_tpu_torch.__main__ import main as cli

    def run_cli(argv, stdin=""):
        """(exit code, stdout) of `python -m bn254_tpu_torch <argv>`, run
        in this process with stdin and stdout redirected."""
        out, saved_in = io.StringIO(), sys.stdin
        sys.stdin = io.StringIO(stdin)
        before = dict(NATIVE.calls)
        try:
            with contextlib.redirect_stdout(out):
                rc = cli(argv)
        finally:
            sys.stdin = saved_in
        cli_core_calls.append((argv[0], calls_since(before)))
        return rc, out.getvalue()

    cli_core_calls = []  # (step, its calls into the host core) of each call

    # the host flows: two fixed keys (the reference's example), their
    # aggregate accepted on its message and rejected on another
    sk_a, sk_b = CLI_KEYS
    outs = [run_cli(a)[1].strip() for a in (
        ["pubkey", sk_a], ["pubkey", sk_b], ["sign", sk_a, "sample"],
        ["sign", sk_b, "sample"])]
    agg_pk = run_cli(["aggregate-pks", outs[0], outs[1]])[1].strip()
    agg_sig = run_cli(["aggregate-sigs", outs[2], outs[3]])[1].strip()
    if run_cli(["verify", agg_pk, agg_sig, "sample"]) != (0, "ok\n"):
        fail("CLI: the aggregate signature was not accepted on its message")
    if run_cli(["verify", agg_pk, agg_sig, "tampered"]) != (1, "FAIL\n"):
        fail("CLI: the aggregate signature was not rejected (rc 1, FAIL) on "
             "another message")
    if run_cli(["hash-to-g1", "sample"]) != (0, HASH_SAMPLE + "\n"):
        fail("CLI: hash-to-g1 of 'sample' differs from the reference's "
             "golden value")
    wrong = [(step, got) for step, got in cli_core_calls
             if got != CLI_CORE_CALLS[step]]
    if wrong:
        fail(f"CLI host steps: calls into the native host core {wrong}, want "
             f"{json.dumps(CLI_CORE_CALLS)} a step")
    phase9_core_calls = {}  # each call's, by step
    for step, got in cli_core_calls:
        phase9_core_calls.setdefault(step, []).append(got)
    print("cli: pubkey, sign, aggregate-pks, aggregate-sigs and verify on two "
          "keys: the aggregate accepted on its message, rejected (rc 1) on "
          "another; hash-to-g1 'sample' = the golden " + HASH_SAMPLE
          + "; calls into the native host core a step "
          + json.dumps(phase9_core_calls))

    # batch-verify in process: NB tuples under 16 keys, messages of three
    # lengths, signed on the card by api.batch_sign, three signatures swapped
    NB, n_keys, n_len = 256, 16, len(CLI_MSG_LENGTHS)
    cli_msgs = [(f"cli-{i:04d}-" + "m" * 64)[:CLI_MSG_LENGTHS[i % n_len]]
                for i in range(NB)]
    cli_sks = [PrivateKey(int.from_bytes(rng.bytes(32), "big"))
               for _ in range(n_keys)]
    cli_pks = [PublicKey.from_private_key(k).to_compressed().hex()
               for k in cli_sks]
    cli_sigs = api.batch_sign([m.encode() for m in cli_msgs],
                              [cli_sks[i % n_keys] for i in range(NB)])
    for i in rng.choice(NB, size=8, replace=False):
        if cli_sigs[i].to_compressed() != ECDSA.sign(
                cli_msgs[i].encode(), cli_sks[i % n_keys]).to_compressed():
            fail(f"CLI fixture: api.batch_sign's signature {i} differs from "
                 "ECDSA.sign's by compressed bytes")
    sig_hexes = [s.to_compressed().hex() for s in cli_sigs]
    cli_bad = [7, NB // 2, NB - 2]
    for i in cli_bad:
        sig_hexes[i] = sig_hexes[i + 1]

    def lines(n, sigs_):
        return "".join(json.dumps({"msg": cli_msgs[i], "sig": sigs_[i],
                                   "pk": cli_pks[i % n_keys]}) + "\n"
                       for i in range(n))

    cli_widths = {}
    reset_counts()
    with launches_recorded(run_launches, cli_widths):
        (rc, out), cli_ms = events_ms(
            torch, lambda: run_cli(["batch-verify"], lines(NB, sig_hexes)))
    cli_counts = {**FK.launches, "montmul": MK.launches}
    faults = cli_launch_faults(FK.launches, n_len)
    if faults or not MK.launches:
        fail("CLI batch-verify: launches " + json.dumps(cli_counts)
             + f" differ from its table ({n_len} message lengths): "
             + "; ".join(faults or ["no montmul launch"]))
    flagged = [i for i, line in enumerate(out.splitlines())
               if line.startswith("FAIL ")]
    want_lines = [f"{'FAIL' if i in cli_bad else 'ok'} {cli_msgs[i]}"
                  for i in range(NB)]
    if rc != 1 or out.splitlines() != want_lines:
        fail(f"CLI batch-verify: rc {rc}, FAIL on lines {flagged}, want rc 1 "
             f"and FAIL on exactly {cli_bad}")
    if cli_core_calls[-1] != ("batch-verify", {"g2_in_subgroup": NB}):
        fail(f"CLI batch-verify: calls into the native host core "
             f"{cli_core_calls[-1][1]}, want {NB} g2_in_subgroup (one key "
             "decode a line)")
    phase9_core_calls["batch-verify"] = [cli_core_calls[-1][1]]

    def cli_batch_verify():
        """ms (CUDA events) of one more in-process batch-verify over the NB
        lines, with its calls into the host core; rc 1 and FAIL on exactly
        the swapped lines, its launches recorded for the final hold."""
        with launches_recorded(run_launches):
            (rc_, out_), ms = events_ms(
                torch, lambda: run_cli(["batch-verify"], lines(NB, sig_hexes)))
        if rc_ != 1 or out_.splitlines() != want_lines:
            fail(f"CLI batch-verify (phase 11): rc {rc_}, want rc 1 and FAIL "
                 f"on exactly {cli_bad}")
        return ms, cli_core_calls[-1][1]
    msgs_b = [m.encode() for m in cli_msgs]
    pk_objs = [PublicKey.from_compressed(bytes.fromhex(cli_pks[i % n_keys]))
               for i in range(NB)]
    _, api_ms = events_ms(torch, lambda: api.batch_verify(
        msgs_b, cli_sigs, pk_objs, mode="independent"))
    print(f"cli batch-verify: {NB} lines, {n_keys} keys, {n_len} message "
          f"lengths {list(CLI_MSG_LENGTHS)}, signed on the card (8 equal to "
          f"ECDSA.sign), rc 1 and FAIL on exactly lines {cli_bad}; "
          f"{cli_ms:.1f} ms (CUDA events, the whole in-process CLI call), "
          f"{api_ms:.1f} ms for api.batch_verify alone on the decoded tuples "
          f"(warm), on {card}; launches {json.dumps(cli_counts)}; lanes per "
          "launch " + json.dumps(lanes(cli_widths)))

    # the real entry points, each in a process of its own, on the card
    root = pathlib.Path(__file__).resolve().parent
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "-m", "bn254_tpu_torch",
                        "batch-verify"], input=lines(16, [
                            s.to_compressed().hex() for s in cli_sigs]),
                       cwd=root, capture_output=True, text=True, timeout=600)
    cli_proc_s = time.perf_counter() - t0
    if r.returncode != 0 or r.stdout.splitlines() != [
            f"ok {cli_msgs[i]}" for i in range(16)]:
        fail(f"python -m bn254_tpu_torch batch-verify: rc {r.returncode}, "
             f"stdout {r.stdout[-300:]!r}, stderr {r.stderr[-600:]!r}")
    t0 = time.perf_counter()
    r = subprocess.run([sys.executable, "examples/batch_verify_gpu.py", "16"],
                       cwd=root, capture_output=True, text=True, timeout=600)
    example_s = time.perf_counter() - t0
    if r.returncode != 0:
        fail(f"examples/batch_verify_gpu.py 16: rc {r.returncode}, stdout "
             f"{r.stdout[-300:]!r}, stderr {r.stderr[-600:]!r}")
    print(f"cli: python -m bn254_tpu_torch batch-verify (no --device) on 16 "
          f"valid lines: rc 0, 16 ok lines, {cli_proc_s:.2f} s; "
          f"examples/batch_verify_gpu.py 16: rc 0, {example_s:.2f} s "
          f"(wall, each a process of its own, kernels loaded from the build "
          f"of phase 2); phase 9 in {time.perf_counter() - t9:.1f} s wall")

    sharded_counts = sharded_phase(args, card, inputs5, run_launches)
    host_core_phase(card, args.seed, core_build_s, phase9_core_calls,
                    cli_ms, cli_batch_verify)

    # every fused kernel against its plain body at each further (lane count,
    # input bounds) the runs of phases 4 to 6, 8 to 11 launched it at
    with torch.inference_mode():
        for key, seen in run_launches.items():
            for n, bounds in sorted(seen - checked[key]):
                top = (max(v for v, _ in bounds) - 1).bit_length()
                lmax = max(lm for _, lm in bounds)
                compare(key, f"{n} lanes, inputs at the bounds a path "
                        f"launched it at (values < 2^{top}, limbs < "
                        f"{lmax})", body_inputs(key, n, bounds=bounds))
    unheld = {k: sorted(n for n, _ in v - checked[k])
              for k, v in run_launches.items() if v - checked[k]}
    if unheld:
        fail(f"launches never held against the plain bodies: {unheld}")
    for key in ("expu_sq2", "fq12_cyc_sq", "fq12_mul_line", "fq12_sq",
                "g2_dbl_step", "g2_add_step", "el_pow_step_mul",
                "el_pow_step_sq"):
        print(f"held: {key} at every (lane count, input bounds) the paths "
              f"launched it at, lanes {lanes(run_launches)[key]}, "
              f"{len(run_launches[key])} bound sets")

    # the chunked phase's times on a warm repeat (CUDA events): each chunk
    # from its points stage to the end of its Miller stage, the final
    # exponentiation with is_one's input, and the whole call
    marks = {"chunk": [], "final_exp": []}

    @contextlib.contextmanager
    def chunk_events():
        points, reduce, final_exp = (BV._fused_points, BV._miller_reduce,
                                     FE.final_exp)

        def event():
            e = torch.cuda.Event(enable_timing=True)
            e.record()
            return e

        def timed_points(*a):
            marks["chunk"].append([event()])
            return points(*a)

        def timed_reduce(*a):
            out = reduce(*a)
            marks["chunk"][-1].append(event())
            return out

        def timed_final_exp(f):
            start = event()
            out = final_exp(f)
            marks["final_exp"].append((start, event()))
            return out

        BV._fused_points, BV._miller_reduce, FE.final_exp = (
            timed_points, timed_reduce, timed_final_exp)
        try:
            yield
        finally:
            BV._fused_points, BV._miller_reduce, FE.final_exp = (
                points, reduce, final_exp)

    reset_counts()
    with chunk_events():
        ok, e2e5_ms = events_ms(torch, lambda: BV.verify_batch_fused_chunked(
            *inputs5, w5, chunk=CH))
    if not bool(ok) or {k: FK.launches[k] for k in FK.KERNELS} != want5:
        fail("the warm chunked run rejected the batch or launched "
             f"{json.dumps(FK.launches)}")
    chunk_ms = [a.elapsed_time(b) for a, b in marks["chunk"]]
    chunked_times = {
        "batch": NC, "chunks": n_ch, "chunk": CH,
        "cut": f"config 5's 128 chunks (1,048,576 tuples) cut to {n_ch}",
        "fixture_s": fixture_s, "fixture_hash_ms_median": float(
            np.median(hash_ms)), "cold_s": chunked_cold_s,
        "chunk_ms_first": chunk_ms[0],
        "chunk_ms_median": float(np.median(chunk_ms)),
        "chunk_ms_last": chunk_ms[-1],
        "final_exp_ms": marks["final_exp"][0][0].elapsed_time(
            marks["final_exp"][0][1]),
        "e2e_ms": e2e5_ms, "verifies_per_s": NC / (e2e5_ms / 1e3),
        "peak_mib_beyond_inputs": peak_mb, "launches": chunk_launches}
    print(f"chunked config 5 on {card} (warm, CUDA events): "
          + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                        for k, v in chunked_times.items()}))
    del inputs5, hx5, hy5, sx5, sy5, qx5, qy5, w5

    # -- 7. times on a warm repeat ---------------------------------------------------
    def stage_times(tag, check_warm, **extra):
        """Warm per-stage ms (CUDA events) of the fused tier under the
        current config, stage by stage as verify_batch_fused runs them,
        then the whole adaptive call, whose launches `check_warm` holds."""
        with torch.inference_mode():
            (hx, hy), hash_ms = events_ms(
                torch, lambda: hash_to_g1_device(msgs, None, dev))
            sx, sy = CV.g1_batch_to_device_affine([s.point for s in sigs],
                                                  dev)
            pqx, pqy = CV.g2_batch_to_device_affine(
                [k.point for k in pks], dev)
            w = BV.random_weights(B, 128, dev)
            pts, points_ms = events_ms(torch, lambda: BV._fused_points(
                hx, hy, sx, sy, pqx, pqy, w, w.half_bits))
            (_, ws), ladder_ms = events_ms(torch, lambda: BV._apply_weights(
                hx, hy, sx, sy, w, w.half_bits))
            _, tree_sum_ms = events_ms(torch, lambda: BV._g1_tree_sum(ws))
            f_red, miller_ms = events_ms(
                torch, lambda: BV._miller_reduce(*pts))
            one, fe_ms = events_ms(
                torch, lambda: T.fq12_is_one(FE.final_exp(f_red)))
            if not bool(one):
                fail(f"the stage-by-stage fused check{tag} rejected the "
                     "valid batch")
            # the final exponentiation's parts, as FE.final_exp runs them
            f_cyc, easy_ms = events_ms(torch, lambda: T.fq12_retag(
                FE.easy_part(T.fq12_retag(f_red))))
            ft1, expu_ms = events_ms(
                torch, lambda: T.fq12_retag(FE.exp_u(f_cyc)))
            ft2 = T.fq12_retag(FE.exp_u(ft1))
            ft3 = T.fq12_retag(FE.exp_u(ft2))
            f_fin, hard_ms = events_ms(torch, lambda: FE._retag_tight(
                FE.hard_combine(f_cyc, ft1, ft2, ft3)))
            one, is_one_ms = events_ms(torch, lambda: T.fq12_is_one(f_fin))
            if not bool(one):
                fail(f"the part-by-part final exponentiation{tag} rejected "
                     "the batch")
        reset_counts()
        t0 = time.perf_counter()
        ok, e2e_ms = events_ms(
            torch, lambda: api.batch_verify(msgs, sigs, pks, mode="adaptive"))
        e2e_host_s = time.perf_counter() - t0
        warm_launches = check_warm(f"warm adaptive run{tag}")
        if not ok.all():
            fail(f"warm adaptive run{tag} rejected the valid batch")
        stages = {
            "hash_ms": hash_ms, "weights_points_ms": points_ms,
            "glv_ladders_ms": ladder_ms, "g1_tree_sum_ms": tree_sum_ms,
            "miller_reduce_ms": miller_ms, "final_exp_is_one_ms": fe_ms,
            "fe_easy_part_ms": easy_ms, "fe_one_exp_u_ms": expu_ms,
            "fe_hard_part_ms": hard_ms, "fe_is_one_ms": is_one_ms,
            "e2e_adaptive_ms": e2e_ms, "verifies_per_s": B / (e2e_ms / 1e3),
            "launches_per_batch": warm_launches,
            "montmul_launches_per_verify": warm_launches["montmul"] / B,
            "warm_host_s": e2e_host_s, "batch": B, **extra,
        }
        print(f"times on {card} (B={B}{tag}, warm, CUDA events): "
              + json.dumps({k: round(v, 4) if isinstance(v, float) else v
                            for k, v in stages.items()}))
        return stages, pts, f_cyc

    _, pts, f_cyc = stage_times("", check_counts, sign_s=sign_s,
                                cold_adaptive_s=cold_s)
    with no_unroll():
        stage_times(f", {nu}", lambda tag: check_scan_counts(tag, scan_want),
                    cold_adaptive_s=scan_cold_s)

    # device busy share (profiler kernel time over unprofiled wall time) of
    # one miller_dbl_body launch on the B+1 rows and of one whole exp_u on
    # the scalar final exponentiation, as the main path runs them
    from torch.profiler import ProfilerActivity, profile

    px, py, qx, qy = pts[:4]
    with torch.inference_mode():
        f0 = M._pin_fq12(T.fq12_one(px.batch_shape, dev))
        t_0 = M._pin_proj(M.ProjG2(qx, qy, T.fq2_one(px.batch_shape, dev)))
        xpp, ypp = M._pin_el(px), M._pin_el(py)

        def exp_u_scan():
            with no_unroll():
                return FE.exp_u(f_cyc)

        probes = [
            ("miller_dbl_body_launch", lambda: FK.fused_op(
                M._dbl_body_impl, "miller_dbl_body", f0, t_0, xpp, ypp)),
            ("exp_u", lambda: FE.exp_u(f_cyc)),
            ("exp_u_no_unroll", exp_u_scan), ("exp_u_no_unroll", exp_u_scan),
            ("exp_u", lambda: FE.exp_u(f_cyc)),
        ]
        for tag, fn in probes:
            fn()
            torch.cuda.synchronize()
            t0_host = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0_host) * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
            # the kernel rows alone: an aten row's self device time is
            # its kernels' time, which their own rows count already
            dev_us = sum(getattr(e, "self_device_time_total",
                                 getattr(e, "self_cuda_time_total", 0))
                         for e in prof.key_averages()
                         if str(e.device_type).endswith("CUDA"))
            n_ops = sum(e.count for e in prof.key_averages()
                        if e.key.startswith("aten::"))
            device_ms = dev_us / 1e3 if dev_us else None
            print(f"busy share, {tag}: wall {wall_ms:.3f} ms, device "
                  f"{device_ms} ms, {n_ops} aten ops (profiler)")

    # the independent tier: stages and verifies/s of pair2 and the stacked
    # form (single-pair bodies), and of the stacked form with
    # unroll_static_loops=False (the scan loop's step ops), in turns
    def independent_times(form):
        with (no_unroll() if form == "stacked_no_unroll"
              else contextlib.nullcontext()):
            return _independent_times(form)

    def _independent_times(form):
        with torch.inference_mode():
            (hx, hy), h_ms = events_ms(
                torch, lambda: hash_to_g1_device(msgs_i, None, dev))
            sx, sy = CV.g1_batch_to_device_affine(
                [s.point for s in sigs_i], dev)
            pqx, pqy = CV.g2_batch_to_device_affine(
                [k.point for k in pks_i], dev)
            if form == "pair2":
                f, m_ms = events_ms(torch, lambda: DP._miller2(
                    hx, hy, pqx, pqy, sx, sy))
            else:
                f, m_ms = events_ms(torch, lambda: T.fq12_retag(
                    DP.fq12_reduce_mul(M.miller_loop(
                        *BV._independent_pairs(hx, hy, sx, sy, pqx, pqy)))))
            one, fe_ms = events_ms(
                torch, lambda: T.fq12_is_one(FE.final_exp(f)))
        if form == "pair2":
            ok, e2e_ms = events_ms(torch, lambda: api.batch_verify(
                msgs_i, sigs_i, pks_i, mode="independent"))
        else:
            ok, e2e_ms = events_ms(
                torch, lambda: stacked_check(msgs_i, sigs_i, pks_i))
        if not (bool(one.all()) and ok.all()):
            fail("a warm independent run rejected the valid batch")
        return {"hash_ms": h_ms, "miller_ms": m_ms,
                "final_exp_is_one_ms": fe_ms, "e2e_ms": e2e_ms,
                "verifies_per_s": NI / (e2e_ms / 1e3)}

    ind_times = {"pair2": [], "stacked": [], "stacked_no_unroll": []}
    for form in ("pair2", "stacked", "stacked_no_unroll",
                 "stacked_no_unroll", "stacked", "pair2"):
        ind_times[form].append(independent_times(form))
    for form, runs in ind_times.items():
        print(f"independent B={NI} {form} on {card} (warm, CUDA events, two "
              "runs): " + json.dumps(
                  [{k: round(v, 4) for k, v in r.items()} for r in runs]))

    # the lane-cooperative kernels: ms per launch of every instantiation
    # at the widths of its rule's steps and of its paths: the Miller, exp_u
    # and Fq12 bodies and the G2 doubling step at 1 lane, 2, 4, 8 and 15
    # lanes per SM, the
    # independent tier's and the Miller rows' widths, the scan loop's line
    # fold, square and doubling step also at the widths the runs with
    # unroll_static_loops=False launched them at; the GLV step at 1 lane, 2
    # lanes per SM, the independent tier's, the Miller rows' and the
    # ladder's widths; the better of two passes over the sizes, and at
    # one lane each size's device time under torch.profiler
    sweep_widths = {**dict.fromkeys(FK.COOP, (1, 2 * sms, 4 * sms, 8 * sms,
                                              15 * sms, NI, B + 1)),
                    "glv_dbl_add": (1, 2 * sms, NI, B + 1, 2 * B)}
    for key in ("fq12_mul_line", "fq12_sq", "g2_dbl_step", "g2_add_step"):
        sweep_widths[key] += tuple(lanes(scan_widths)[key])
    coop_sweep = []
    with torch.inference_mode():
        for key, widths in sweep_widths.items():
            for n in sorted(set(widths)):
                packed, _ = FK.pack(L.tree_leaves(body_inputs(key, n)))
                out = torch.empty((FK.arity(key)[1], NLIMBS, n),
                                  dtype=torch.int64, device=dev)
                ms = {}  # the better of two passes over the sizes
                for _ in range(2):
                    for g in FK.INSTANCES[key]:
                        FK.launch_group(key, packed, out, g)
                        t = events_ms(torch, lambda: FK.launch_group(
                            key, packed, out, g), reps=50)[1]
                        ms[g] = min(ms.get(g, t), t)
                row = {"key": key, "lanes": n, "per_sm": -(-n // sms),
                       "rule_group": FK.coop_group(key, n, sms),
                       "ms_by_group": ms}
                if n == 1:  # device time alone: launches cost as much here
                    row["profiler_ms_by_group"] = {}
                    for g in FK.INSTANCES[key]:
                        with profile(activities=[ProfilerActivity.CUDA]) as prof:
                            for _ in range(50):
                                FK.launch_group(key, packed, out, g)
                            torch.cuda.synchronize()
                        dev_us = sum(getattr(e, "self_device_time_total", 0)
                                     for e in prof.key_averages()
                                     if "_kernel" in e.key)
                        row["profiler_ms_by_group"][g] = (
                            dev_us / 1e3 / 50 if dev_us else None)
                coop_sweep.append(row)
                print(f"coop {key}: {n} lanes ({row['per_sm']} a SM), ms per "
                      f"launch by G {json.dumps(ms)}, the rule's "
                      f"G={row['rule_group']}"
                      + (", profiler ms a launch by "
                         f"G {json.dumps(row['profiler_ms_by_group'])}"
                         if n == 1 else ""))
    print(json.dumps({"coop_sweep": coop_sweep}))

    # per kernel: ms per launch at its path's width, bound, plain ms
    kernels = []
    a_c, b_c = a_w.contiguous(), b_w.contiguous()
    _, k_ms = events_ms(torch, lambda: MK.montmul_cuda(a_c, b_c), reps=50)
    _, p_ms = events_ms(torch, lambda: MK.montmul_plain(a_c, b_c), reps=5)
    t_bytes = 3 * NLIMBS * 8 * wide / HBM_BYTES_PER_S * 1e3
    t_ops = LEAF_MADS * wide / INT32_MAD_PER_S * 1e3
    kernels.append({
        "name": "montmul", "route": "cuda",
        "source": "bn254_tpu_torch/kernels/montmul.cu",
        "replaces": "bn254_tpu/kernels/montmul.py:50",
        "path": "adaptive", "launches": main_launches["montmul"],
        "max_abs_err": max_err["montmul"],
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": max(t_bytes, t_ops),
        "bound_by": "bytes" if t_bytes >= t_ops else "operations",
        "library_ms": None, "chunked_launches": chunk_launches["montmul"],
        "cli_batch_verify_launches": cli_counts["montmul"],
        "sharded_launches": {tag: c["montmul"]
                             for tag, c in sharded_counts.items()},
    })
    def launch_ms(key, args_):
        """ms per launch of the bare kernel on these inputs, warm."""
        packed, _ = FK.pack(L.tree_leaves(args_))
        out = torch.empty((FK.arity(key)[1], NLIMBS, packed.shape[2]),
                          dtype=torch.int64, device=dev)
        FK._launch(key, packed, out)
        return events_ms(torch, lambda: FK._launch(key, packed, out),
                         reps=50)[1]

    def kernel_row(key, n, path, n_launches, widths):
        """The kernels-line row of `key` at n lanes: ms per launch, plain
        ms, bound."""
        body = FK.signature(key)[0]
        n_in, n_out = FK.arity(key)
        args_ = body_inputs(key, n)
        leaves = [0]
        with plain_leaf(leaves):  # products per lane, on 1 lane
            body(*body_inputs(key, 1))
        ms = launch_ms(key, args_)
        _, wrap_ms = events_ms(torch, lambda: FK.fused_op(body, key, *args_),
                               reps=5)
        with plain_leaf():
            _, plain_ms = events_ms(torch, lambda: body(*args_), reps=3)
        t_bytes = (n_in + n_out) * NLIMBS * 8 * n / HBM_BYTES_PER_S * 1e3
        t_ops = leaves[0] * LEAF_MADS * n / INT32_MAD_PER_S * 1e3
        print(f"kernel {key} ({path} path): {n} lanes, {leaves[0]} leaf "
              f"products per lane, {ms:.4f} ms per launch ({wrap_ms:.4f} ms "
              f"through fused_op), plain {plain_ms:.3f} ms, bound "
              f"{max(t_bytes, t_ops):.6f} ms")
        row = {
            "name": key, "route": "cuda",
            "source": "bn254_tpu_torch/kernels/fused.cu",
            "replaces": FK.KERNELS[key].replaces, "path": path,
            "launches": n_launches, "max_abs_err": max_err[key], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None, "chunked_launches": chunk_launches[key],
            "cli_batch_verify_launches": cli_counts[key],
            "sharded_launches": {tag: c[key]
                                 for tag, c in sharded_counts.items()},
        }
        if key in FK.INSTANCES:  # G at each width it runs
            row["groups"] = {str(w): FK.coop_group(key, w, sms)
                             for w in sorted({n, *widths[key]})}
        return row

    # each kernel on the path that runs it: the two-pair bodies on the
    # independent tier, fq12_sq (only inside the Miller bodies on the
    # others) and the scan loop's step ops on the adaptive path with
    # unroll_static_loops=False, the rest on the adaptive path; and the
    # kernels the independent run shares with the adaptive path, at the
    # widest width and the launch count of the independent run
    shared = []
    with torch.inference_mode():
        for key in FK.KERNELS:
            if key in PAIR2:
                kernels.append(kernel_row(key, WIDTHS[key], "independent",
                                          ind_launches[key], lanes(ind_widths)))
                continue
            if key in SCAN_MILLER_LAUNCHES:
                kernels.append(kernel_row(key, WIDTHS[key],
                                          "adaptive_no_unroll",
                                          scan_launches[key],
                                          lanes(scan_widths)))
                continue
            kernels.append(kernel_row(key, WIDTHS[key], "adaptive",
                                      main_launches[key], lanes(main_widths)))
            if key in ind_widths:
                shared.append(kernel_row(
                    key, max(n for n, _ in ind_widths[key]), "independent",
                    ind_launches[key], lanes(ind_widths)))
    print(json.dumps({"independent_path_kernels": shared}))
    print(f"chip_smoke: every phase passed in "
          f"{time.perf_counter() - t_start:.1f} s wall")
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
