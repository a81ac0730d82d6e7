"""The ranks of a cell that asks for more than one card: one process a card.

Rank 0 is the process that runs the cell (`harness.run_cell`). Once the
seed's inputs are in the cache, `Ranks.start` launches ranks 1..n-1 as

    python3 -m bench_gpu.ranks '<json: the rank's part of the run>'

each on its own card (`device_for`). Every rank loads the same cached
inputs and builds the configuration's entry with a `RankInfo`, through
which the entry joins the port's process group. Between calls, outside
each timed call, rank 0 writes one line to every rank's standard input:
"call <index> <1 if a window call>", and "end" once it has made its last
call. A rank makes each call as it is told, its collectives in step with
the others, and after "end" writes one pickled dict to its standard output
and exits: its verdict for every call, the `SumProbe` captures of the
window calls drawn from the seed (the same reservoir as rank 0's), its
card's peak allocated bytes, the modules of JAX or the JAX package loaded
in it (`run.foreign_modules`, read as the result goes), and the error it
met, if any. Anything else a
rank prints goes to standard error.

A rank dies with rank 0 (PR_SET_PDEATHSIG), and rank 0 ends every rank it
started before `stop` returns. A rank that dies or hangs
shows in rank 0 as a collective that raises after `TIMEOUT_S`, or as a
rank that `finish` finds dead or silent.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys
import threading
import time
import traceback
from pathlib import Path

TIMEOUT_S = 60.0  # every collective of the group gives up after this
RESULT_S = 120.0  # a rank's time from "end" to its result and its exit
KILL_WAIT_S = 10.0
PR_SET_PDEATHSIG = 1


@dataclasses.dataclass(frozen=True)
class RankInfo:
    """What an entry needs to join the process group."""

    rank: int
    world: int
    address: str  # "host:port" of the group's store
    timeout_s: float = TIMEOUT_S
    backend: str | None = None  # None: the port's default for the device


def device_for(device: str, rank: int) -> str:
    """The device of `rank`: its own card, `cuda:<rank>` (modulo the cards
    there are: several ranks on one card only over gloo, in tests), or the
    CPU."""
    import torch

    if torch.device(device).type != "cuda":
        return device
    return f"cuda:{rank % torch.cuda.device_count()}"


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class RankFailed(RuntimeError):
    """A rank died, or its result did not come."""


class Ranks:
    """Rank 0's handle on ranks 1..n-1."""

    def __init__(self, world: int, address: str, procs: list, log):
        self.world = world
        self.address = address
        self.procs = procs  # rank r is procs[r - 1]
        self.log = log
        self.results: dict[int, dict] = {}

    @classmethod
    def start(cls, world: int, run: dict, faults: dict, log=sys.stderr):
        """Start ranks 1..world-1 of a run. `run`: the keys of the run that
        every rank shares (workload, the cell's keys; seed, device,
        overrides, traffic_overrides, cache, backend); `faults`: rank ->
        names of faults.py's faults planted in that rank."""
        from .spec import REPO

        address = f"127.0.0.1:{_free_port()}"
        procs = []
        for r in range(1, world):
            part = {**run, "rank": r, "world": world, "address": address,
                    "parent": os.getpid(), "faults": faults.get(r, [])}
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "bench_gpu.ranks", json.dumps(part)],
                cwd=REPO, stdin=subprocess.PIPE, stdout=subprocess.PIPE))
        print(f"ranks: started ranks 1..{world - 1} (pids "
              + " ".join(str(p.pid) for p in procs) + f"), group at "
              f"{address}", file=log)
        return cls(world, address, procs, log)

    def info(self, backend: str | None = None) -> RankInfo:
        return RankInfo(0, self.world, self.address, TIMEOUT_S, backend)

    def _send(self, line: str) -> None:
        for r, p in enumerate(self.procs, 1):
            if p.poll() is not None:
                raise RankFailed(f"rank {r} exited with code {p.returncode}")
            p.stdin.write(line.encode() + b"\n")
            p.stdin.flush()

    def call(self, index: int, window: bool) -> None:
        """Tell every rank to make call `index` (a window call: one that
        its SumProbe may sample)."""
        self._send(f"call {index} {int(window)}")

    def finish(self) -> dict[int, dict]:
        """Send "end" and take each rank's result within RESULT_S;
        {rank: result} of the ranks whose result came. The ranks then
        leave the process group and exit: `stop` waits for them."""
        with contextlib.suppress(OSError):
            for p in self.procs:
                p.stdin.write(b"end\n")
                p.stdin.close()
        got: dict[int, dict] = {}

        def read(r, p):
            with contextlib.suppress(Exception):
                got[r] = pickle.load(p.stdout)

        readers = [threading.Thread(target=read, args=(r, p), daemon=True)
                   for r, p in enumerate(self.procs, 1)]
        for t in readers:
            t.start()
        deadline = time.monotonic() + RESULT_S
        for t in readers:
            t.join(max(0.0, deadline - time.monotonic()))
        self.results = dict(got)
        return self.results

    def stop(self, wait_s: float = 0.0) -> None:
        """End every rank: wait up to `wait_s` for each to exit, then kill
        it, and reap it."""
        deadline = time.monotonic() + wait_s
        for r, p in enumerate(self.procs, 1):
            try:
                p.wait(max(0.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                print(f"ranks: rank {r} did not exit; killed", file=self.log)
                p.kill()
                try:
                    p.wait(KILL_WAIT_S)
                except subprocess.TimeoutExpired:
                    print(f"ranks: rank {r} outlived SIGKILL", file=self.log)
            for f in (p.stdin, p.stdout):
                with contextlib.suppress(OSError):
                    f.close()


# -- a rank other than 0 ----------------------------------------------------


def _die_with_parent(parent: int) -> None:
    """Have the kernel kill this process when rank 0 ends (Linux)."""
    import ctypes
    import signal

    with contextlib.suppress(Exception):
        ctypes.CDLL(None, use_errno=True).prctl(PR_SET_PDEATHSIG,
                                                signal.SIGKILL)
    if os.getppid() != parent:
        os._exit(1)


def main(argv=None) -> int:
    part = json.loads((argv or sys.argv[1:])[0])
    _die_with_parent(part["parent"])
    # the protocol's result goes to the real standard output alone
    out = os.fdopen(os.dup(1), "wb")
    os.dup2(2, 1)
    from .run import foreign_modules

    r = part["rank"]
    result = {"rank": r, "verdicts": [], "captured": [], "peak": 0,
              "foreign": [], "error": None}

    def send():
        result["foreign"] = foreign_modules()
        pickle.dump(result, out)
        out.flush()
        result["sent"] = True

    try:
        with contextlib.ExitStack() as stack:
            _run(part, result, stack)
            send()  # before the group closes: rank 0 waits for it
    except BaseException:
        result["error"] = traceback.format_exc()
        print(f"rank {r}: " + result["error"], file=sys.stderr)
        if "sent" not in result:
            send()
    return 0 if result["error"] is None else 1


def _run(part: dict, result: dict, stack: contextlib.ExitStack) -> None:
    import torch

    from . import faults
    from . import harness as H
    from . import inputs as INP
    from . import spec

    device = device_for(part["device"], part["rank"])
    on_card = torch.device(device).type == "cuda"
    if on_card:
        torch.cuda.set_device(device)  # before anything else meets a card
        from bn254_tpu_torch.kernels import build

        for lib in ("fused", "montmul"):
            build.library(lib)
    wl = part["workload"]
    cfg = {**spec.config(wl["config"]), **part["overrides"]}
    traffic = {**spec.traffic(wl["traffic"]), **part["traffic_overrides"]}
    data = INP.load(wl["name"], cfg, traffic, part["seed"],
                    Path(part["cache"]))
    for name in part["faults"]:
        stack.enter_context(faults.planted(name))
    info = RankInfo(part["rank"], part["world"], part["address"], TIMEOUT_S,
                    part["backend"])
    caller = spec.entry(cfg["entry"]).Caller(cfg, data, device, rank=info)
    stack.callback(caller.close)
    sums = H.SumProbe(part["seed"], H.SUM_SAMPLE)
    stack.callback(sums.restore)
    for line in sys.stdin:
        cmd = line.split()
        if not cmd or cmd[0] == "end":
            break
        index, window = int(cmd[1]), cmd[2] == "1"
        if window:
            sums.begin()
        result["verdicts"].append((index, caller.call(index)))
        if window:
            sums.end(index)
    result["captured"] = sums.host()
    if on_card:
        result["peak"] = torch.cuda.max_memory_allocated(device)


if __name__ == "__main__":
    sys.exit(main())
