"""Run one cell of the benchmark of `bn254_tpu_torch` once, on the CUDA card.

    python3 -m bench_gpu.run --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

from the root of a checkout. It prints the cell's end-to-end metrics
(`--trace 0`) or per-layer metrics (`--trace 1`) as one JSON line, the last
line of standard output, and the numbers its check compares, each with its
limit, as the last lines of standard error. It exits with another code than
0, and prints no result, when there is no CUDA card or fewer than the cell
asks for, when a BN254_* knob is set (the cell runs `config.DEFAULT`), or
when JAX or the JAX package was loaded in this process or, in a cell of
several ranks, in any other rank's.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

FOREIGN = frozenset({"jax", "jaxlib", "flax", "bn254_tpu"})


def foreign_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & FOREIGN)


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    knobs = sorted(k for k in os.environ if k.startswith("BN254_"))
    if knobs:
        print("error: the cell runs config.DEFAULT, but these knobs are set: "
              + ", ".join(knobs), file=sys.stderr)
        return 2
    from . import spec

    chips = spec.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"error: the cell needs {chips} CUDA card(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    from . import harness

    result = harness.run_cell(args.workload, args.seed, args.seconds,
                              bool(args.trace), t_start=T_START)
    # this process's, and in a cell of several ranks every other rank's
    found = foreign_modules() + result.pop("foreign", [])
    if found:
        print("error: loaded in this process: " + ", ".join(found),
              file=sys.stderr)
        return 3
    print("knobs: no BN254_* variable set; config.DEFAULT", file=sys.stderr)
    for name, c in result["checks"].items():
        print(f"check {name}: {c['value']} (limit {c['limit']})",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
