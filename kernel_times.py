#!/usr/bin/env python3
"""ms per launch of bn254_tpu_torch's fused kernels at given lane counts.

    python3 kernel_times.py --key fq12_mul --lanes 1,2,4,4096 [--repo DIR]

For each key it times the bare kernel (`fused._launch`: for a
lane-cooperative kernel, the group size G its launcher's rule picks) on
random inputs at the pinned bounds (values < 2^262, limbs < 2^16) made
from a fixed seed, CUDA events around 50 back-to-back launches after one
warm launch, and the same 50 launches' device time under torch.profiler
(at a few lanes the launches themselves take longer than the kernel).
`--repo`
names the checkout whose `bn254_tpu_torch` is built and timed (default:
this file's), so that the kernels of another commit are timed by the same
code. It prints the card's name and power limit, then one JSON object per
key:
{"key", "repo", "lanes": {n: ms}, "device_ms": {n: ms},
"groups": {n: G} or null}.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import sys

REPS = 50
SEED = 2026


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--key", action="append", required=True)
    ap.add_argument("--lanes", required=True,
                    help="comma-separated lane counts")
    ap.add_argument("--repo", default=str(pathlib.Path(__file__).parent))
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
    from bn254_tpu_torch.kernels import fused as FK
    from bn254_tpu_torch.utils import convert as CV
    from bn254_tpu_torch.utils import samples as SM

    if not pathlib.Path(FK.__file__).resolve().is_relative_to(repo):
        print(f"kernel_times: imported {FK.__file__}, not from {repo}",
              file=sys.stderr)
        return 3
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60).stdout.strip()
    print(card)
    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    pins = (L.STD_BOUND, 1 << 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    for key in args.key:
        n_in, n_out = FK.arity(key)
        ms, device_ms, groups = {}, {}, {}
        for n in widths:
            packed, _ = FK.pack([CV.from_numpy(
                SM.bounded_limbs(rng, *pins, n), *pins, dev)
                for _ in range(n_in)])
            out = torch.empty((n_out, L.NLIMBS, n), dtype=torch.int64,
                              device=dev)
            FK._launch(key, packed, out)
            torch.cuda.synchronize()
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                FK._launch(key, packed, out)
            end.record()
            end.synchronize()
            ms[n] = start.elapsed_time(end) / REPS
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                for _ in range(REPS):
                    FK._launch(key, packed, out)
                torch.cuda.synchronize()
            dev_us = sum(getattr(e, "self_device_time_total", 0)
                         for e in prof.key_averages() if "_kernel" in e.key)
            device_ms[n] = dev_us / 1e3 / REPS if dev_us else None
            if key in getattr(FK, "INSTANCES", {}):
                groups[n] = FK.coop_group(key, n, sms)
            elif key in getattr(FK, "COOP", ()):  # one rule for all keys
                groups[n] = FK.coop_group(n, sms)
        print(json.dumps({"key": key, "repo": str(repo), "lanes": ms,
                          "device_ms": device_ms, "groups": groups or None}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
