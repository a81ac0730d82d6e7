"""The lane-cooperative kernels (`miller_dbl_body`, `expu_step`,
`miller_dbl_body2`, `miller_add_body2`, `fq12_mul`, `miller_add_body`,
`glv_dbl_add`, `expu_sq2`, `fq12_cyc_sq`, `fq12_mul_line`, `fq12_sq`,
`g2_dbl_step`, `g2_add_step`, `g1_add`) off the card.

Their level schedules (`kernels/coop_schedule.py`, generated into
`coop_schedule.cuh`) are checked twice:

* in Python: the tables run level by level on Python ints (Montgomery
  products; `glv_dbl_add`'s and `g1_add`'s masked selects as SEL
  chains), each level
  reading only slots that earlier levels wrote and writing no slot another
  op of the level reads; every product of the formula computed exactly
  once (117, 90, 160, 123, 54, 80, 30, 36, 18, 39, 36, 42, 41 and 23, plus
  one load per input El, no two products of the same operands); every
  output written once, equal to the plain body by value; each schedule's tables byte for
  byte as they were measured on the card;
* through the g++ build of `fused.cu` (`-DBN254_CHECK_BOUNDS`), whose host
  launchers run the same `coop_op` over each level with the group's
  threads g = 0..G-1 in turn: for every group size each kernel is built
  for, equal to the plain body by canonical value with no failed bound
  check, on pinned and boundary inputs (`utils/samples.bounded_limbs`);
  and with some arguments as unbatched (18,) Els that `fused.pack`
  broadcasts (the two-pair bodies' constant line triple, `fq12_mul`'s
  second factor, `miller_add_body`'s G1 point); the two cyclotomic
  squaring kernels on easy-part outputs against the JAX package's generic
  Fq12 square; the sparse line fold against the JAX package's
  `_fq12_mul_line_impl`; and the Fq12 square and the G2 doubling and
  addition steps against its `_fq12_sq_impl`, `_dbl_step_impl` and
  `_add_step_impl`.
"""

import ctypes
import hashlib
import inspect
import pathlib
import shutil
import subprocess

import numpy as np
import pytest

from bn254_tpu_torch.constants import MONT_R, NLIMBS, P
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.kernels import coop_schedule as CS
from bn254_tpu_torch.kernels import fused as FK
from bn254_tpu_torch.utils import convert as CV
from bn254_tpu_torch.utils import samples as SM

SRC = pathlib.Path(FK.__file__).resolve().parent / "fused.cu"
PINNED = (L.STD_BOUND, 1 << 16)
N = 5


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("coop_host") / "coop_host.so"
    r = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-DBN254_CHECK_BOUNDS",
         "-x", "c++", str(SRC), "-o", str(out)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out))


def inputs(key, bounds, seed, n=N):
    """(n_in, 18, n) limbs within `bounds`, boundary lanes first."""
    rng = np.random.default_rng(seed)
    return np.stack([SM.bounded_limbs(rng, *bounds, n)
                     for _ in range(FK.arity(key)[0])])


def plain_values(key, packed, bounds):
    """The plain body's outputs (CPU `fused_op`) as ints mod p, per El."""
    args = FK.args_from_leaves(
        key, [CV.from_numpy(x, *bounds) for x in packed])
    out = FK.fused_op(FK.signature(key)[0], key, *args)
    return [[int(v) % P for v in L.to_ints(e)] for e in L.tree_leaves(out)]


def test_header_is_current():
    assert CS.HEADER.read_text() == CS.header_text(), (
        "run python -m bn254_tpu_torch.kernels.coop_schedule")


# sha256 of each schedule's ops, chain steps and level starts, as 16-bit
# little-endian words: the tables these kernels were measured with
TABLE_DIGESTS = {
    "miller_dbl_body":
        "cc950a6527d7db53090db8c5d3bd2aecadd6a149b13277d9cdbc94e4a51d684a",
    "expu_step":
        "eca09c919e79eb34d0f7a7ee7cfbe5b8ae4f5c5c2fcf8d23a4e317517b10cea7",
    "miller_dbl_body2":
        "2adb212980b1fff0397f584b826c2e69ca037426b0af76f6f0ee42b1dfa8da63",
    "miller_add_body2":
        "c81ab1a770dd0424f35c40ba34c82b737183f8b07ab658e863bad542096d2e80",
    "fq12_mul":
        "6cbe0f443b366436a662d0d086a43c32977843e96277436fbb064db8249b0db3",
    "miller_add_body":
        "e43c56853bf90427553c2c5b429104f7cf758d570535c8efc7672299c1491f2a",
    "glv_dbl_add":
        "7539ad2894447fc22ebee2acea6985393744f851f277676068bf4107f4af752b",
    "expu_sq2":
        "b2586c04fc3033fcc2392dd6d4d9d10c1da1adf99c7304f6160498dab36a4b46",
    "fq12_cyc_sq":
        "0e5982406bdc12b0bbb9e85dcaa154088c697676b92b086fe1cc3b04311eac58",
    "fq12_mul_line":
        "0323622c01d793e9a0821bbf7ee2f07288e6989d2fa7c467c9207ac59a20016e",
    "fq12_sq":
        "8bb3ac93226d2f23450b1fe419e6e86fc8643c407425189996f0a97b56c4ecdc",
    "g2_dbl_step":
        "74b581db375eeea47f9de0340ceac5d0cb23e8274f82a43462a16bc43d4bff53",
    "g2_add_step":
        "596309849e39f8620c182d9b10e5a362bd9830b295dfff2e563c0e236d3853e8",
    "g1_add":
        "dbff5816bc99f4e694946363ec37bc0ad89406b913833363477b36fd9b586a7a",
}


def table_digest(s):
    words = [w for op in s.ops for w in (op.kind << 14 | (op.out & 0x3FFF),
                                          op.gout, op.a, op.b)]
    data = np.array(words + s.steps + s.level_first, dtype="<u2").tobytes()
    return hashlib.sha256(data).hexdigest()


def test_older_tables_are_unchanged():
    assert {k: table_digest(CS.schedule(k)) for k in TABLE_DIGESTS} == \
        TABLE_DIGESTS


def run_table(s, ins):
    """The schedule on Python ints (LOAD: the input mod p; MUL: a b / R;
    SEL: its takes under its zero tests), level by level; fails on a read
    of a slot no earlier level wrote, a slot written twice in a level or
    read there by another op, and an output written twice. Returns
    (outputs, operand pairs of the MULs)."""
    rinv = pow(MONT_R, -1, P)
    slots, written, outs, pairs = {}, {}, [None] * s.n_out, []
    mask = (1 << CS.SLOT_BITS) - 1
    for lv in range(s.levels):
        wrote, read = {}, {}
        for i, op in enumerate(s.ops[s.level_first[lv]:s.level_first[lv + 1]]):
            def rd(x):
                assert written.get(x, lv) < lv and x not in wrote, (lv, x)
                read.setdefault(x, set()).add(i)
                return slots[x]

            if op.kind == CS.LOAD:
                v = ins[op.a] % P
            elif op.kind == CS.MUL:
                a, b = rd(op.a), rd(op.b)
                pairs.append(frozenset((a, b)))
                v = a * b * rinv % P
            elif op.kind == CS.SEL:
                v, hold = None, True
                for w in s.steps[op.a:op.a + op.b]:
                    code, x = w >> CS.SLOT_BITS, w & mask
                    if code in (CS.IF_ZERO, CS.IF_NONZERO):
                        hold &= (rd(x) == 0) == (code == CS.IF_ZERO)
                        continue
                    if code == CS.TAKE:
                        y = rd(x)
                    else:
                        y = MONT_R % P if code == CS.TAKE_ONE else 0
                    assert v is not None or hold  # the first step takes
                    v, hold = y if hold else v, True
            else:
                v = None
                for w in s.steps[op.a:op.a + op.b]:
                    code, x = w >> CS.SLOT_BITS, w & mask
                    if code == CS.ZERO:
                        v = 0
                    elif code == CS.DBL:
                        v = 2 * v % P
                    elif code == CS.SET:
                        v = rd(x)
                    else:
                        y = rd(x)
                        v = {CS.ADD: v + y, CS.SUB: v - y, CS.RSUB: y - v}[code] % P
            if op.out != CS.NONE:
                assert op.out not in wrote, (lv, op.out)
                wrote[op.out] = i
                slots[op.out] = v
            if op.gout != CS.NONE:
                assert outs[op.gout] is None
                outs[op.gout] = v
        for x, i in wrote.items():
            assert read.get(x, set()) <= {i}, (lv, x)  # only its own operand
            written[x] = lv
    return outs, pairs


@pytest.mark.parametrize("key", sorted(CS.BODIES))
def test_schedule_levels_and_products(key):
    s = CS.schedule(key)
    n_in, n_out = FK.arity(key)
    assert (s.n_in, s.n_out) == (n_in, n_out)
    assert s.products == CS.BODIES[key][1]
    assert sum(op.kind == CS.LOAD for op in s.ops) == n_in
    assert sorted(op.a for op in s.ops if op.kind == CS.LOAD) == list(range(n_in))
    assert s.level_first[0] == 0 and s.level_first[-1] == len(s.ops)
    packed = inputs(key, PINNED, 3)
    want = plain_values(key, packed, PINNED)
    for lane in range(N):
        outs, pairs = run_table(s, [int(v) for v in L.to_ints(packed[:, :, lane].T)])
        assert outs == [w[lane] for w in want]
        assert len(pairs) == s.products
    # lanes 0-2 are edges (equal or zero inputs); on random ones no two
    # products have the same operands
    assert len(set(pairs)) == s.products


def host(lib, key):
    fn = getattr(lib, f"bn254_host_{key}_g")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn


def check_host(lib, key, group, packed, bounds):
    n_out = FK.arity(key)[1]
    n = packed.shape[2]
    got = np.zeros((n_out, NLIMBS, n), dtype=np.int64)
    inp = np.ascontiguousarray(packed)
    faults = host(lib, key)(inp.ctypes.data, got.ctypes.data, n, group)
    assert faults == 0, f"{faults} bound checks failed"
    assert int(got.max()) < 1 << 15 and int(got.min()) >= 0
    want = plain_values(key, packed, bounds)
    for i in range(n_out):
        vals = [int(v) for v in L.to_ints(got[i])]
        assert all(v < P for v in vals)  # canonical
        assert vals == want[i], (key, group, i)


@pytest.mark.parametrize("key, group", [
    (k, g) for g in max(FK.INSTANCES.values(), key=len)
    for k in sorted(CS.BODIES) if g in FK.INSTANCES[k]])
def test_host_schedule_matches_plain(host_lib, key, group):
    check_host(host_lib, key, group, inputs(key, PINNED, group), PINNED)


@pytest.mark.parametrize("key", sorted(CS.BODIES))
def test_host_schedule_carries_lazy_inputs(host_lib, key):
    """Inputs beyond the pins (values < 2^262, limbs < 2^20), carried by
    the LOAD ops, with the rule's group for N lanes."""
    bounds = (1 << 262, 1 << 20)
    fn = getattr(host_lib, f"bn254_host_{key}")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    packed = inputs(key, bounds, 11)
    got = np.zeros((FK.arity(key)[1], NLIMBS, N), dtype=np.int64)
    assert fn(np.ascontiguousarray(packed).ctypes.data, got.ctypes.data, N) == 0
    want = plain_values(key, packed, bounds)
    assert [[int(v) for v in L.to_ints(g)] for g in got] == want


# the arguments held as unbatched (18,) Els: the constant line triple, as
# the pair2 loop passes it; for fq12_mul and miller_add_body, an operand
# shared by every lane, which `fused.pack` broadcasts the same way
UNBATCHED = {"miller_dbl_body2": ("ca", "cb", "cc"),
             "miller_add_body2": ("ca", "cb", "cc"),
             "fq12_mul": ("b",),
             "miller_add_body": ("xp", "yp")}


@pytest.mark.parametrize("key", sorted(UNBATCHED))
def test_host_schedule_with_unbatched_constants(host_lib, key):
    """The arguments of `UNBATCHED` as unbatched (18,) Els beside batched
    operands: packed by `fused.pack`, read by the schedule at every G,
    equal to the plain body on the unbatched arguments."""
    body = FK.signature(key)[0]
    names = list(inspect.signature(body).parameters)
    args = list(FK.args_from_leaves(
        key, [CV.from_numpy(x, *PINNED) for x in inputs(key, PINNED, 17)]))
    for j, name in enumerate(UNBATCHED[key]):
        i = names.index(name)
        args[i] = L.tree_map(
            lambda e: L.El(e.arr[:, 3 + j % 2], e.vmax, e.lmax), args[i])
        assert all(e.arr.shape == (NLIMBS,) for e in L.tree_leaves(args[i]))
    packed, batch = FK.pack(L.tree_leaves(args))
    assert batch == (N,)
    packed = np.ascontiguousarray(packed.numpy())
    with FK.kernel_mode():
        want = [[int(v) % P for v in L.to_ints(e)]
                for e in L.tree_leaves(body(*args))]
    for group in FK.INSTANCES[key]:
        got = np.zeros((FK.arity(key)[1], NLIMBS, N), dtype=np.int64)
        assert host(host_lib, key)(packed.ctypes.data, got.ctypes.data, N,
                                   group) == 0
        assert [[int(v) for v in L.to_ints(g)] for g in got] == want, group


def test_group_rule(host_lib):
    """Each cooperative kernel's rule picks only instantiated sizes, at
    one lane (the shared final exponentiation), 4,096 (the independent
    tier), 8,193 (the B=8192 Miller rows), 16,384 (the GLV ladder) and more
    lanes on a 132-SM card, takes no larger size for more lanes, and the
    host refuses a size with no instantiation."""
    for key, sizes in FK.INSTANCES.items():
        picks = FK.coop_groups(key, host_lib)
        assert set(picks) <= set(sizes), key
        by_n = [FK.coop_group(key, n, 132, host_lib)
                for n in (1, 132, 4096, 8193, 16384, 65536, 1 << 20)]
        assert set(by_n) <= set(picks), key
        assert by_n == sorted(by_n, reverse=True), key
    for key, size in (("expu_step", 12), ("expu_step", 1), ("glv_dbl_add", 3)):
        packed = inputs(key, PINNED, 0, n=1)
        out = np.zeros((FK.arity(key)[1], NLIMBS, 1), dtype=np.int64)
        assert host(host_lib, key)(packed.ctypes.data, out.ctypes.data, 1,
                                   size) == -1


def test_host_cyclotomic_squares_match_jax_generic_square(host_lib):
    """`fq12_cyc_sq` and `expu_sq2` at every G on easy-part outputs,
    f^((p^6-1)(p^2+1)), where the Granger-Scott formula holds: equal by
    value to the JAX package's generic `fq12_sq` applied once and twice."""
    from bn254_tpu.fields import limbs as JL
    from bn254_tpu.fields import tower as JT

    rng = np.random.default_rng(31)

    def mont():
        return JL.to_mont(JL.from_ints(
            [int.from_bytes(rng.bytes(32), "little") % P for _ in range(N)]))

    f = JT.Fq12(*[JT.Fq6(*[JT.Fq2(mont(), mont()) for _ in range(3)])
                  for _ in range(2)])
    g = JT.fq12_mul(JT.fq12_conj(f), JT.fq12_inv(f))
    e = JT.fq12_retag(JT.fq12_mul(JT.fq12_frob(g, 2), g))
    sq = JT.fq12_sq(e)
    wants = {"fq12_cyc_sq": sq, "expu_sq2": JT.fq12_sq(sq)}

    def els(x):  # tree order: c0.c0.c0, c0.c0.c1, ..., c1.c2.c1
        return [el for six in x for fq2 in six for el in fq2]

    leaves = els(e)
    assert all(x.vmax <= FK.IN_BOUNDS[0] and x.lmax <= FK.IN_BOUNDS[1]
               for x in leaves)
    packed = np.ascontiguousarray(
        np.stack([np.asarray(x.arr).astype(np.int64) for x in leaves]))
    for key, want in wants.items():
        want_vals = [[int(v) % P for v in JL.to_ints(x.arr)]
                     for x in els(want)]
        assert want_vals[0] != [int(v) % P for v in JL.to_ints(leaves[0].arr)]
        for group in FK.INSTANCES[key]:
            got = np.zeros((12, NLIMBS, N), dtype=np.int64)
            assert host(host_lib, key)(packed.ctypes.data, got.ctypes.data, N,
                                       group) == 0
            assert [[int(v) for v in L.to_ints(x)] for x in got] == \
                want_vals, (key, group)


def check_host_against_jax(lib, key, seed, jax_body):
    """The host build of `key` at every G against `jax_body(els)`, the JAX
    package's body on the same numpy inputs at the pins (`els` yields them
    as JAX Els in tree order), by value; outputs in the JAX body's tree
    order."""
    from bn254_tpu.fields import limbs as JL

    import jax.numpy as jnp

    packed = inputs(key, PINNED, seed)
    want = jax_body(iter([JL.El(jnp.asarray(x.astype(np.uint32)), *PINNED)
                          for x in packed]))
    leaves = [x for six in want for pair in six for x in pair]
    assert len(leaves) == FK.arity(key)[1]
    want_vals = [[int(v) % P for v in JL.to_ints(x.arr)] for x in leaves]
    for group in FK.INSTANCES[key]:
        got = np.zeros((len(leaves), NLIMBS, N), dtype=np.int64)
        assert host(lib, key)(np.ascontiguousarray(packed).ctypes.data,
                              got.ctypes.data, N, group) == 0
        assert [[int(v) for v in L.to_ints(x)] for x in got] == \
            want_vals, group


def jax_fq2(els):
    from bn254_tpu.fields import tower as JT

    return JT.Fq2(next(els), next(els))


def jax_fq12(els):
    from bn254_tpu.fields import tower as JT

    return JT.Fq12(*[JT.Fq6(jax_fq2(els), jax_fq2(els), jax_fq2(els))
                     for _ in range(2)])


def test_host_line_fold_matches_jax(host_lib):
    """`fq12_mul_line` at every G against the JAX package's
    `_fq12_mul_line_impl` on the same numpy inputs at the pins, by value."""
    from bn254_tpu.pairing import miller as JM

    check_host_against_jax(host_lib, "fq12_mul_line", 37, lambda els: (
        JM._fq12_mul_line_impl(jax_fq12(els), jax_fq2(els), jax_fq2(els),
                               jax_fq2(els))))


@pytest.mark.parametrize("key", ["fq12_sq", "g2_dbl_step"])
def test_host_square_and_doubling_match_jax(host_lib, key):
    """`fq12_sq` and `g2_dbl_step` at every G against the JAX package's
    `_fq12_sq_impl` and `_dbl_step_impl` (the point, then the line)."""
    from bn254_tpu.fields import tower as JT
    from bn254_tpu.pairing import miller as JM

    bodies = {
        "fq12_sq": lambda els: JT._fq12_sq_impl(jax_fq12(els)),
        "g2_dbl_step": lambda els: JM._dbl_step_impl(
            JM.ProjG2(jax_fq2(els), jax_fq2(els), jax_fq2(els)), next(els),
            next(els)),
    }
    check_host_against_jax(host_lib, key, 41, bodies[key])


def test_host_add_step_matches_jax(host_lib):
    """`g2_add_step` at every G against the JAX package's `_add_step_impl`
    (T + Q, then the chord line) on the same numpy inputs at the pins."""
    from bn254_tpu.pairing import miller as JM

    check_host_against_jax(host_lib, "g2_add_step", 43, lambda els: (
        JM._add_step_impl(
            JM.ProjG2(jax_fq2(els), jax_fq2(els), jax_fq2(els)),
            jax_fq2(els), jax_fq2(els), next(els), next(els))))
