#!/usr/bin/env python3
"""ms per launch of bn254_tpu_torch's fused kernels at given lane counts.

    python3 kernel_times.py --key fq12_mul --lanes 1,2,4,4096 [--repo DIR]
                            [--leaf cios|cios_wide] [--every-group] [--sass]
                            [--exp-u]

For each key it times the bare kernel (`fused._launch`: for a
lane-cooperative kernel, the group size G its launcher's rule picks) on
random inputs at the pinned bounds (values < 2^262, limbs < 2^16) made
from a fixed seed, CUDA events around 50 back-to-back launches after one
warm launch, and the same 50 launches' device time under torch.profiler
(at a few lanes the launches themselves take longer than the kernel).
`--repo`
names the checkout whose `bn254_tpu_torch` is built and timed (default:
this file's), so that the kernels of another commit are timed by the same
code. `--leaf` builds `fused.cu` with every cooperative schedule's
products over that leaf (`-DBN254_WIDE_LEAF`) instead of each schedule's
own; `--every-group` also times a cooperative key at every G it is built
for; `--sass` prints the SASS instruction counts of the timed keys'
cooperative kernels (cuobjdump). It prints the card's name and power
limit, then one JSON object per key:
{"key", "repo", "leaf", "lanes": {n: ms}, "device_ms": {n: ms},
"groups": {n: G} or null, "info": {G: occupancy, shared memory,
registers} or null, "by_group": {n: {G: [ms, device ms]}} or null}.
`--exp-u` adds one `final_exp.exp_u` on a one-lane easy-part output, in
each loop form (`config.DEFAULT.unroll_static_loops` True and False, in
turns: default, scan, scan, default), its wall ms and its kernels' device
ms under torch.profiler: {"exp_u": {form: [{"wall_ms", "device_ms"}, ...]},
"repo"}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys
import time

REPS = 50
SEED = 2026


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--key", action="append", default=[])
    ap.add_argument("--lanes", default="1",
                    help="comma-separated lane counts")
    ap.add_argument("--repo", default=str(pathlib.Path(__file__).parent))
    ap.add_argument("--leaf", choices=("schedule", "cios", "cios_wide"),
                    default="schedule")
    ap.add_argument("--every-group", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--exp-u", action="store_true")
    args = ap.parse_args()
    widths = [int(n) for n in args.lanes.split(",")]
    repo = pathlib.Path(args.repo).resolve()
    sys.path.insert(0, str(repo))

    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    from bn254_tpu_torch.fields import limbs as L
    from bn254_tpu_torch.kernels import build
    from bn254_tpu_torch.kernels import fused as FK
    from bn254_tpu_torch.utils import convert as CV
    from bn254_tpu_torch.utils import samples as SM

    if not pathlib.Path(FK.__file__).resolve().is_relative_to(repo):
        print(f"kernel_times: imported {FK.__file__}, not from {repo}",
              file=sys.stderr)
        return 3
    if args.leaf != "schedule":
        if "BN254_WIDE_LEAF" not in (build.SRC_DIR / "fused.cu").read_text():
            print(f"kernel_times: {repo}'s fused.cu has no BN254_WIDE_LEAF",
                  file=sys.stderr)
            return 3
        build.NVCC_FLAGS = (*build.NVCC_FLAGS, "-DBN254_WIDE_LEAF="
                            f"{int(args.leaf == 'cios_wide')}")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    pins = (L.STD_BOUND, 1 << 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count

    def timed(launch):
        """(event ms, profiler device ms) per launch of `launch`."""
        launch()
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(REPS):
            launch()
        end.record()
        end.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(REPS):
                launch()
            torch.cuda.synchronize()
        dev_us = sum(getattr(e, "self_device_time_total", 0)
                     for e in prof.key_averages() if "_kernel" in e.key)
        return (start.elapsed_time(end) / REPS,
                dev_us / 1e3 / REPS if dev_us else None)

    instances = getattr(FK, "INSTANCES", {})
    for key in args.key:
        n_in, n_out = FK.arity(key)
        ms, device_ms, groups, by_group = {}, {}, {}, {}
        for n in widths:
            packed, _ = FK.pack([CV.from_numpy(
                SM.bounded_limbs(rng, *pins, n), *pins, dev)
                for _ in range(n_in)])
            out = torch.empty((n_out, L.NLIMBS, n), dtype=torch.int64,
                              device=dev)
            ms[n], device_ms[n] = timed(lambda: FK._launch(key, packed, out))
            if key in instances:
                groups[n] = FK.coop_group(key, n, sms)
                if args.every_group:
                    by_group[n] = {g: timed(lambda: FK.launch_group(
                        key, packed, out, g)) for g in instances[key]}
            elif key in getattr(FK, "COOP", ()):  # one rule for all keys
                groups[n] = FK.coop_group(n, sms)
        info = ({g: FK.coop_info(key, g) for g in instances[key]}
                if key in instances else None)
        print(json.dumps({"key": key, "repo": str(repo), "leaf": args.leaf,
                          "lanes": ms, "device_ms": device_ms,
                          "groups": groups or None, "info": info,
                          "by_group": by_group or None}))
    if args.sass:
        from chip_smoke import sass_counts

        names = tuple(f"coop_kernel<Coop{k.title().replace('_', '')}, "
                      for k in args.key)
        for line in sass_counts(build.nvcc(), str(build._output("fused")),
                                lambda fn: fn.startswith(names)):
            print(f"sass ({args.leaf}): {line}")
    if args.exp_u:
        print(json.dumps({"exp_u": exp_u_times(rng, dev), "repo": str(repo)}))
    return 0


def exp_u_times(rng, dev):
    """Wall and profiler device ms of one exp_u on a one-lane easy-part
    output, in each loop form, in turns."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from bn254_tpu_torch import config as C
    from bn254_tpu_torch.constants import P
    from bn254_tpu_torch.fields import tower as T
    from bn254_tpu_torch.kernels import fused as FK
    from bn254_tpu_torch.pairing import final_exp as FE
    from bn254_tpu_torch.utils import convert as CV
    from bn254_tpu_torch.utils import samples as SM

    canon = (P, 1 << 15)
    (f,) = FK.args_from_leaves("fq12_cyc_sq", [  # random lanes follow 0-2
        CV.from_numpy(SM.bounded_limbs(rng, *canon, 4)[:, 3:], *canon, dev)
        for _ in range(12)])
    saved, rows = C.DEFAULT, {}
    with torch.inference_mode():
        f_cyc = T.fq12_retag(FE.easy_part(T.fq12_retag(f)))
        for form in ("default", "no_unroll", "no_unroll", "default"):
            C.DEFAULT = saved.replace(unroll_static_loops=form == "default")
            try:
                FE.exp_u(f_cyc)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                FE.exp_u(f_cyc)
                torch.cuda.synchronize()
                wall_ms = (time.perf_counter() - t0) * 1e3
                with profile(activities=[ProfilerActivity.CUDA]) as prof:
                    FE.exp_u(f_cyc)
                    torch.cuda.synchronize()
            finally:
                C.DEFAULT = saved
            dev_us = sum(getattr(e, "self_device_time_total", 0)
                         for e in prof.key_averages())
            rows.setdefault(form, []).append(
                {"wall_ms": wall_ms, "device_ms": dev_us / 1e3})
    return rows


if __name__ == "__main__":
    sys.exit(main())
