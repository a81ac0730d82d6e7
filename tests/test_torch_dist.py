"""The port's sharded layer (dist/mesh.py, dist/collectives.py and
`dist/batch_verify.make_sharded_verifier`) in one process, against the
JAX package.

- The Fq12-product all-reduce: n seeded Fq12 values, one a rank, at
  n = 3, 5, 7 and 8. The port's gather is stood in for by the stack of
  every rank's packed value (what `all_gather` returns on every rank; the
  real gather runs in tests/test_torch_multiprocess.py); each rank's
  product must have the same limbs as every other rank's and the
  canonical value of the JAX package's `fq12_allreduce_mul` on the
  8-device virtual CPU mesh (tests/conftest.py). Likewise the G1
  all-reduce against JAX's `jacobian_allreduce_add`. The result does not
  depend on the order of the shards.
- A world-size-1 gloo process group: `all_gather`, `make_mesh`, and the
  sharded verifier at B = 4 one-shot and in chunks of 2 through the g++
  build of fused.cu (`host_card`): valid accepts, tampered rejects, with
  chip_smoke.py's launch table (`sharded_launches`); batches and chunks
  that do not divide raise. Its shard-local Fq12 is held against the JAX
  package's `_fused_local_product` by canonical value.
"""

import numpy as np
import pytest
import torch
import torch.distributed as dist

import jax
from jax.sharding import Mesh as JMesh, PartitionSpec as PSpec

import chip_smoke
from bn254_tpu.curve import g1 as JG1
from bn254_tpu.dist import collectives as JCOLL
from bn254_tpu.fields import limbs as JL
from bn254_tpu.fields import tower as JT
from bn254_tpu_torch.constants import P
from bn254_tpu_torch.curve import g1 as DG1
from bn254_tpu_torch.curve import glv as GLV
from bn254_tpu_torch.dist import batch_verify as BV
from bn254_tpu_torch.dist import collectives as COLL
from bn254_tpu_torch.dist import mesh as MESH
from bn254_tpu_torch.errors import InvalidLengthError
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.fields import tower as T
from bn254_tpu_torch.host import curve as HC
from bn254_tpu_torch.host import field as HF
from test_torch_chunked import BITS, PAIRS, B, tuples
from test_torch_fused_host import host_card, host_lib  # noqa: F401

CPU = torch.device("cpu")


def rand_fq12s(seed, n):
    """n host Fq12 values (nested int tuples) from a seeded generator."""
    rng = np.random.default_rng(seed)

    def fp():
        return int.from_bytes(rng.bytes(32), "big") % P

    return [tuple(tuple((fp(), fp()) for _ in range(3)) for _ in range(2))
            for _ in range(n)]


def jax_allreduce(fn, dev_value, n):
    """`fn(x, "batch", n)` over an n-device CPU mesh, one batch lane a
    shard; the (batch n) output of every shard."""
    mesh = JMesh(np.array(jax.devices()[:n]), axis_names=("batch",))

    def shard_fn(x):
        x1 = jax.tree_util.tree_map(lambda a: a[:, 0], x)
        return jax.tree_util.tree_map(lambda a: a[:, None],
                                      fn(x1, "batch", n))

    return jax.jit(jax.shard_map(shard_fn, mesh=mesh,
                                 in_specs=PSpec(None, "batch"),
                                 out_specs=PSpec(None, "batch"),
                                 check_vma=False))(dev_value)


def gathered_ranks(values, monkeypatch):
    """Every rank's view of a mesh of len(values): `all_gather` returns the
    stack of all ranks' packed values, as the collective does."""
    stacked = torch.stack([COLL.pack(v) for v in values])
    monkeypatch.setattr(COLL, "all_gather", lambda buf, mesh: stacked)
    return [MESH.Mesh(None, len(values), r, "batch", CPU)
            for r in range(len(values))]


def jax_fq12(hs):
    """JAX Fq12 with one batch lane per host value."""
    def conv(path):
        return JL.to_mont(JL.from_ints([path(h) for h in hs]))

    return JT.Fq12(*[JT.Fq6(*[JT.Fq2(conv(lambda h, s=s, i=i: h[s][i][0]),
                                     conv(lambda h, s=s, i=i: h[s][i][1]))
                              for i in range(3)]) for s in range(2)])


def canon12(f):
    """Canonical host value of a port Fq12 (scalar batch)."""
    return tuple(tuple((int(c0), int(c1)) for c0, c1 in six)
                 for six in T.fq12_to_host(f))


@pytest.mark.parametrize("n", [3, 5, 7, 8])
def test_fq12_allreduce_mul_matches_jax(n, monkeypatch):
    hs = rand_fq12s(100 + n, n)
    jouts = JT.fq12_to_host(jax_allreduce(JCOLL.fq12_allreduce_mul,
                                          jax_fq12(hs), n))
    want = HF.FQ12_ONE
    for h in hs:
        want = HF.fq12_mul(want, h)
    want = HF._canon12(want)
    for j in range(n):
        assert tuple(tuple((int(a[j]), int(b[j])) for a, b in six)
                     for six in jouts) == want

    values = [T.fq12_from_host(h) for h in hs]
    outs = [COLL.fq12_allreduce_mul(values[m.rank], m)
            for m in gathered_ranks(values, monkeypatch)]
    for out in outs:  # the same limbs on every rank
        assert torch.equal(COLL.pack(out), COLL.pack(outs[0]))
        assert all(e.vmax == L.STD_BOUND for e in L.tree_leaves(out))
    assert canon12(outs[0]) == want


def test_fq12_allreduce_shard_order_and_runs(monkeypatch):
    """The product does not depend on which rank holds which value (by
    canonical value), and two runs give the same limbs."""
    hs = rand_fq12s(23, 8)
    runs = []
    for order in (range(8), reversed(range(8)), range(8)):
        values = [T.fq12_from_host(hs[i]) for i in order]
        m = gathered_ranks(values, monkeypatch)[3]
        runs.append(COLL.fq12_allreduce_mul(values[3], m))
    assert canon12(runs[0]) == canon12(runs[1])
    assert torch.equal(COLL.pack(runs[0]), COLL.pack(runs[2]))


@pytest.mark.parametrize("n", [3, 8])
def test_g1_allreduce_add_matches_jax(n, monkeypatch):
    pts = [HC.g1_mul(HC.G1_ONE, 3 + 5 * i) for i in range(n)]
    want = HC.g1_to_affine(HC.g1_mul(HC.G1_ONE,
                                     sum(3 + 5 * i for i in range(n))))
    jres = JG1.to_host_affine(jax_allreduce(
        lambda p, a, k: JCOLL.jacobian_allreduce_add(p, JG1.add, a, k),
        JG1.from_host(pts), n))
    assert jres == [want] * n

    values = [DG1.from_host(pt) for pt in pts]
    for m in gathered_ranks(values, monkeypatch):
        out = COLL.jacobian_allreduce_add(values[m.rank], m)
        assert DG1.to_host_affine(*DG1.to_affine(out)) == [want]


def test_allreduce_rejects_bad_axis_size():
    with pytest.raises(InvalidLengthError):
        COLL.allreduce_monoid(None, None, MESH.Mesh(None, 0, 0, "batch", CPU))


@pytest.fixture
def world1(tmp_path):
    """A world-size-1 gloo process group (FileStore under tmp_path),
    destroyed at teardown, and its mesh on the CPU."""
    dist.init_process_group(
        "gloo", store=dist.FileStore(str(tmp_path / "store"), 1), rank=0,
        world_size=1)
    try:
        yield MESH.make_mesh(device="cpu")
    finally:
        dist.destroy_process_group()


def test_world1_mesh_and_gather(world1):
    assert (world1.size, world1.rank, world1.backend) == (1, 0, "gloo")
    assert MESH.process_info() == (0, 1) and not MESH.is_multiprocess()
    buf = COLL.pack(T.fq12_one((), CPU))
    assert buf.shape == (12 * 18,)
    assert torch.equal(COLL.all_gather(buf, world1), buf[None])
    with pytest.raises(InvalidLengthError):
        MESH.make_mesh(2, device="cpu")


def test_mesh_without_a_group_and_device_rules(monkeypatch):
    """No process group: a world of one. No CUDA: the card is refused
    unless the caller asks for the CPU, by `initialize` and `make_mesh`."""
    monkeypatch.setattr(MESH, "_device", None)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    m = MESH.make_mesh(device="cpu")
    assert (m.group, m.size, m.rank, m.backend) == (None, 1, 0, None)
    with pytest.raises(RuntimeError, match="CUDA"):
        MESH.make_mesh()
    with pytest.raises(RuntimeError, match="CUDA"):
        MESH.initialize(coordinator_address="127.0.0.1:1", num_processes=2)
    assert not MESH.initialize(device="cpu")  # no coordinator: no-op
    assert MESH.make_mesh().device == CPU  # the device initialize chose
    with pytest.raises(ValueError, match="NCCL"):
        MESH.initialize(coordinator_address="127.0.0.1:1", num_processes=2,
                        device="cpu", backend="nccl")


def test_shard_tree_slices_each_rank():
    w = GLV.glv_weights_to_device([(i, 2 * i) for i in range(6)], 32)
    x = L.from_ints(list(range(6)))
    for r in range(3):
        m = MESH.Mesh(None, 3, r, "batch", CPU)
        sx, sw = MESH.shard_tree((x, w), m)
        assert [int(v) for v in L.to_ints(sx)] == [2 * r, 2 * r + 1]
        assert [int(v) for v in L.to_ints(sw.b)] == [4 * r, 4 * r + 2]
        assert sw.bits == 32
    with pytest.raises(InvalidLengthError):
        MESH.shard_tree(x, MESH.Mesh(None, 4, 0, "batch", CPU))


def launches(world, chunks, rows):
    """A rank's fused launches: chip_smoke.py's table (for 128-bit weights)
    with this test's 16-step GLV ladder a chunk."""
    return {k: v for k, v in {
        **chip_smoke.sharded_launches(world, chunks, rows),
        "glv_dbl_add": chunks * BITS // 2}.items() if v}


@pytest.mark.parametrize("chunk", [None, 2], ids=["one-shot", "chunked"])
@pytest.mark.parametrize("tamper", [None, 3], ids=["valid", "tampered"])
def test_sharded_verifier_world1(world1, host_card, chunk, tamper):
    run = BV.make_sharded_verifier(world1)
    w = GLV.glv_weights_to_device(PAIRS, BITS)
    ok = run(*tuples(tamper), w, chunk=chunk)
    assert ok.shape == () and ok.dtype == torch.bool
    assert bool(ok) == (tamper is None)
    n_chunks = 1 if chunk is None else B // chunk
    assert host_card(**launches(1, n_chunks, B // n_chunks))


def test_sharded_verifier_checks_its_batch(world1):
    """Batches and chunks that do not divide raise before any work, as do
    a mesh axis the verifier was not built for."""
    w = GLV.glv_weights_to_device(PAIRS, BITS)
    args = tuples()
    run = BV.make_sharded_verifier(world1)
    for chunk in (3, 0, 5):
        with pytest.raises(InvalidLengthError):
            run(*args, w, chunk=chunk)
    three = BV.make_sharded_verifier(MESH.Mesh(None, 3, 0, "batch", CPU))
    with pytest.raises(InvalidLengthError, match="mesh axis size 3"):
        three(*args, w)
    two = BV.make_sharded_verifier(MESH.Mesh(None, 2, 0, "batch", CPU))
    with pytest.raises(InvalidLengthError, match="chunk 1"):
        two(*args, w, chunk=1)
    with pytest.raises(ValueError, match="axis"):
        BV.make_sharded_verifier(world1, axis_name="tuples")


# the JAX program compiles `_fused_local_product` (~20 s): a fresh
# subprocess, as tests/test_torch_verify.py runs its JAX pipeline
@pytest.mark.isolated
def test_shard_local_product_matches_jax(world1, host_card, monkeypatch):
    """The rank's local Fq12 (the input of the all-reduce) equals the JAX
    package's `_fused_local_product` on the same shard and weights by
    canonical value."""
    from bn254_tpu.curve import glv as JGLV
    from bn254_tpu.dist import batch_verify as JBV

    local = []
    allreduce = COLL.fq12_allreduce_mul
    monkeypatch.setattr(COLL, "fq12_allreduce_mul",
                        lambda f, mesh: local.append(f) or allreduce(f, mesh))
    assert bool(BV.make_sharded_verifier(world1)(
        *tuples(), GLV.glv_weights_to_device(PAIRS, BITS)))

    def jel(e):
        return JL.El(jax.numpy.asarray(e.arr.numpy().astype(np.uint32)),
                     e.vmax, e.lmax)

    hx, hy, sx, sy, pqx, pqy = tuples()
    jargs = (*map(jel, (hx, hy, sx, sy)), JT.Fq2(jel(pqx.c0), jel(pqx.c1)),
             JT.Fq2(jel(pqy.c0), jel(pqy.c1)))
    jw = JGLV.glv_weights_to_device(PAIRS, BITS)
    jf = jax.jit(lambda *a: JBV._fused_local_product(*a, BITS // 2))(
        *jargs, jw)
    want = tuple(tuple((int(a), int(b)) for a, b in six)
                 for six in JT.fq12_to_host(jf))
    assert canon12(local[0]) == want
