"""Multi-PROCESS sharded verification of the port (the counterpart of
tests/test_multiprocess.py).

Spawns N python processes of this file, each one rank of a
`torch.distributed` gloo process group over TCP on localhost, started by
`dist.mesh.initialize` with device="cpu". The ranks' fused kernels run
through the g++ build of fused.cu (built once by the parent,
tests/test_torch_fused_host.py's `host_lib`), as `host_card` runs them.

- 2 ranks run `make_sharded_verifier` on B = 4 tuples (2 a rank) with
  32-bit GLV weights: every rank accepts the valid batch with
  chip_smoke.py's launch table (`sharded_launches`), rejects the tampered
  one, and holds the same gathered Fq12 limbs as the other rank.
- 3 ranks run the collectives alone: the Fq12 product and the G1 sum of
  one seeded value a rank, the same limbs on every rank, equal to the
  host oracle's product and sum.

Each rank prints MP-* lines the parent asserts on; each `communicate`
has a time limit, and the survivors are killed on failure.

    python tests/test_torch_multiprocess.py <verify|collective> \
        <rank> <world> <port> <host library>
"""

import json
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if __name__ == "__main__":  # a rank: the package and the tests' helpers
    sys.path[:0] = [REPO, os.path.join(REPO, "tests")]

from test_torch_fused_host import host_fn, host_lib  # noqa: E402, F401

TIMEOUT_S = 120


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_ranks(mode: str, nproc: int, lib_path: str):
    port = _free_port()
    procs = [
        subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), mode, str(i),
             str(nproc), str(port), lib_path],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=REPO)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for i, (p, out) in enumerate(zip(procs, outs)):
        tail = "\n".join(out.splitlines()[-30:])
        assert p.returncode == 0, f"rank {i} failed:\n{tail}"
        assert f"MP-INIT proc={i} world={nproc}" in out, tail
        assert f"MP-DONE proc={i}" in out, tail
    return outs


def _lines(out: str, tag: str) -> dict:
    """The JSON objects of a rank's `<tag> {...}` lines, by their key."""
    found = {}
    for line in out.splitlines():
        if line.startswith(tag + " "):
            found.update(json.loads(line[len(tag) + 1:]))
    return found


@pytest.fixture(scope="module")
def lib_path(host_lib):
    return host_lib._name


def test_two_ranks_sharded_verification(lib_path):
    import chip_smoke
    from test_torch_chunked import B, BITS

    outs = _run_ranks("verify", 2, lib_path)
    results = [_lines(out, "MP-RESULT") for out in outs]
    want = {k: v for k, v in {
        **chip_smoke.sharded_launches(2, 1, B // 2),
        "glv_dbl_add": BITS // 2}.items() if v}
    for i, r in enumerate(results):
        assert r["valid"] is True and r["tampered"] is False, (i, r)
        assert r["launches"] == want, (i, r["launches"])
    assert results[0]["limbs"] == results[1]["limbs"]
    assert len(results[0]["limbs"]) == 12 * 18


def test_three_ranks_collectives(lib_path):
    outs = _run_ranks("collective", 3, lib_path)
    results = [_lines(out, "MP-RESULT") for out in outs]
    for r in results:
        assert r["fq12_ok"] is True and r["g1_ok"] is True, r
        assert r["fq12_limbs"] == results[0]["fq12_limbs"]
        assert r["g1_limbs"] == results[0]["g1_limbs"]


# ---------------------------------------------------------------------------
# the rank process
# ---------------------------------------------------------------------------


def _card_through_host_build(lib_path):
    """`fused_op`'s CUDA path with the g++ build standing in for the card,
    as tests/test_torch_fused_host.py's `host_card` sets it up."""
    import ctypes

    from bn254_tpu_torch.fields import tower as T
    from bn254_tpu_torch.kernels import fused as FK

    lib = ctypes.CDLL(lib_path)

    def launch(key, packed, out):
        fn = host_fn(lib, key)
        assert fn(packed.data_ptr(), out.data_ptr(), packed.shape[2]) == 0

    T._on_card = lambda els: True
    FK._on_cuda = lambda els: True
    FK._launch = launch


def _verify(rank, mesh):
    from bn254_tpu_torch.curve import glv as GLV
    from bn254_tpu_torch.dist import batch_verify as BV
    from bn254_tpu_torch.dist import collectives as COLL
    from bn254_tpu_torch.kernels import fused as FK
    from test_torch_chunked import BITS, PAIRS, tuples

    gathered = []
    allreduce = COLL.fq12_allreduce_mul

    def recorded(f, mesh_):
        gathered.append(allreduce(f, mesh_))
        return gathered[-1]

    COLL.fq12_allreduce_mul = recorded
    run = BV.make_sharded_verifier(mesh)
    w = GLV.glv_weights_to_device(PAIRS, BITS)  # the same on every rank
    FK.launches.update(dict.fromkeys(FK.launches, 0))
    ok = bool(run(*tuples(), w))
    launches = {k: v for k, v in FK.launches.items() if v}
    bad = bool(run(*tuples(tamper=3), w))
    return {"valid": ok, "tampered": bad, "launches": launches,
            "limbs": COLL.pack(gathered[0]).tolist()}


def _collective(rank, world, mesh):
    import numpy as np

    from bn254_tpu_torch.constants import P
    from bn254_tpu_torch.curve import g1 as DG1
    from bn254_tpu_torch.dist import collectives as COLL
    from bn254_tpu_torch.fields import tower as T
    from bn254_tpu_torch.host import curve as HC
    from bn254_tpu_torch.host import field as HF

    rng = np.random.default_rng(31)  # the same values on every rank
    hs = [tuple(tuple((int.from_bytes(rng.bytes(32), "big") % P,
                       int.from_bytes(rng.bytes(32), "big") % P)
                      for _ in range(3)) for _ in range(2))
          for _ in range(world)]
    f = COLL.fq12_allreduce_mul(T.fq12_from_host(hs[rank]), mesh)
    want = HF.FQ12_ONE
    for h in hs:
        want = HF.fq12_mul(want, h)
    got = tuple(tuple((int(a), int(b)) for a, b in six)
                for six in T.fq12_to_host(f))

    p = COLL.jacobian_allreduce_add(
        DG1.from_host(HC.g1_mul(HC.G1_ONE, 3 + 5 * rank)), mesh)
    g1_want = HC.g1_to_affine(HC.g1_mul(
        HC.G1_ONE, sum(3 + 5 * i for i in range(world))))
    return {"fq12_ok": got == HF._canon12(want),
            "fq12_limbs": COLL.pack(f).tolist(),
            "g1_ok": DG1.to_host_affine(*DG1.to_affine(p)) == [g1_want],
            "g1_limbs": COLL.pack(p).tolist()}


def _rank_main(argv):
    mode, rank, world, port, lib_path = argv
    rank, world = int(rank), int(world)
    import torch.distributed as dist

    from bn254_tpu_torch.dist import mesh as MESH

    _card_through_host_build(lib_path)
    assert MESH.initialize(coordinator_address=f"127.0.0.1:{port}",
                           num_processes=world, process_id=rank,
                           device="cpu", timeout=TIMEOUT_S)
    assert MESH.process_info() == (rank, world) and MESH.is_multiprocess()
    mesh = MESH.make_mesh()
    assert (mesh.size, mesh.rank, mesh.backend) == (world, rank, "gloo")
    print(f"MP-INIT proc={rank} world={world}", flush=True)
    try:
        result = (_verify(rank, mesh) if mode == "verify"
                  else _collective(rank, world, mesh))
        print("MP-RESULT " + json.dumps(result), flush=True)
    finally:
        dist.destroy_process_group()
    print(f"MP-DONE proc={rank}", flush=True)


if __name__ == "__main__":
    _rank_main(sys.argv[1:])
