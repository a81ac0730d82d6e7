"""Run one cell with a fault of `faults.py` planted in the program (the
control by default), to see the check come out not correct.

    python3 -m bench_gpu.control [--fault <name>] --workload <cell> \
        --seed <n> --seconds <s> --trace 0

The benchmark's own runs never run it.
"""

from __future__ import annotations

import argparse
import sys

from . import faults, run


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--fault", choices=sorted(faults.FAULTS),
                   default=faults.CONTROL)
    args, rest = p.parse_known_args(argv)
    print(f"planted: {args.fault}", file=sys.stderr)
    with faults.planted(args.fault):
        return run.main(rest)


if __name__ == "__main__":
    sys.exit(main())
