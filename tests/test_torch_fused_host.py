"""The fused CUDA kernels' arithmetic, built for the host with g++.

`bn254_tpu_torch/kernels/fused.cu` and its device library
`bn254_tower.cuh` compile under a host compiler into `bn254_host_<key>`
launchers that run the same lane bodies the card runs. With
BN254_CHECK_BOUNDS defined, every CIOS operand limb is checked < 2^16,
every Fp result < 2p with limbs < 2^15, and every loaded value < 2^270.
Each body is held against the port's plain body (what CPU tensors run) on 5
lanes, boundary lanes included: by canonical value, and every output within
the bounds the plain body declares; the two-pair Miller bodies also with
their constant line triple unbatched; `glv_dbl_add`'s and `g1_add`'s
edge lanes at every group size G, the two pow windows on lazy inputs and `el_pow_step_sq`
against the JAX package's `_pow_step_sq`. The two leaves, `cios` and
`cios_wide`, are held bit for bit against `montmul_plain` and each other.
This is the only run of the kernels' arithmetic off the card.
"""

import ctypes
import inspect
import pathlib
import shutil
import subprocess

import numpy as np
import pytest
import torch

from bn254_tpu_torch.constants import NLIMBS, P
from bn254_tpu_torch.curve import glv as GLV
from bn254_tpu_torch.curve import jacobian as J
from bn254_tpu_torch.curve.ops import FqOps
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.fields import tower as T
from bn254_tpu_torch.host import curve as HC
from bn254_tpu_torch.kernels import fused as FK
from bn254_tpu_torch.kernels import montmul as MK
from bn254_tpu_torch.pairing import final_exp as FE
from bn254_tpu_torch.pairing import miller as M
from bn254_tpu_torch.pairing import precompute as PC
from bn254_tpu_torch.utils import convert as CV
from bn254_tpu_torch.utils import samples as SM

SRC = pathlib.Path(FK.__file__).resolve().parent / "fused.cu"
N = 5
PINNED = (L.STD_BOUND, 1 << 16)


@pytest.fixture(scope="module")
def host_lib(tmp_path_factory):
    gxx = shutil.which("g++")
    if gxx is None:
        pytest.skip("g++ is not installed")
    out = tmp_path_factory.mktemp("fused_host") / "fused_host.so"
    r = subprocess.run(
        [gxx, "-O1", "-std=c++17", "-shared", "-fPIC", "-DBN254_CHECK_BOUNDS",
         "-x", "c++", str(SRC), "-o", str(out)],
        capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr
    return ctypes.CDLL(str(out))


def boundary_limbs(rng, n_els):
    """(n_els, 18, N) limbs within the pinned bound (value < 2^262, limbs
    < 2^16): lane 0 the value 2^262-1 with every low limb as large as the
    bound allows, lane 1 the value 2^262-1 canonical, lane 2 zero, lanes 3..
    random lazy limbs (`samples.bounded_limbs`)."""
    return np.stack([SM.bounded_limbs(rng, *PINNED, N) for _ in range(n_els)])


@pytest.mark.parametrize("vmax, lmax", [PINNED, (1 << 261, 1 << 17),
                                        (1 << 270, 1 << 26)],
                         ids=["pins", "scan-loop", "load-limit"])
def test_bounded_limbs_reach_their_edges(vmax, lmax):
    """The shared input generator: every value below vmax and limb below
    lmax, lanes 0 and 1 at vmax - 1 (every low limb of lane 0 within 2^15
    of lmax, lane 1 canonical), lane 2 zero."""
    rng = np.random.default_rng(vmax.bit_length() + lmax.bit_length())
    x = SM.bounded_limbs(rng, vmax, lmax, 64)
    assert x.shape == (NLIMBS, 64) and x.min() >= 0 and x.max() < lmax
    vals = [int(v) for v in L.to_ints(x)]
    assert max(vals) < vmax
    assert vals[0] == vals[1] == vmax - 1 and vals[2] == 0
    assert int(x[:-1, 0].min()) >= lmax - (1 << 15)
    assert int(x[:, 1].max()) < 1 << 15


def host_fn(lib, key, group=None):
    """bn254_host_<key>(in, out, n) -> failed bound checks; with `group`,
    bn254_host_<key>_g at that many threads per lane."""
    args = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64]
    if group is None:
        fn = getattr(lib, f"bn254_host_{key}")
        fn.argtypes, fn.restype = args, ctypes.c_int
        return fn
    fn = getattr(lib, f"bn254_host_{key}_g")
    fn.argtypes, fn.restype = args + [ctypes.c_int], ctypes.c_int
    return lambda inp, out, n: fn(inp, out, n, group)


def check_against_plain(lib, key, packed, bounds=PINNED, group=None):
    """The host build of `key` (at `group` threads per lane, else by its
    rule) on `packed` against the plain body (CPU `fused_op`) by canonical
    value and the declared bounds; returns the plain body's output leaves."""
    n_in, n_out = FK.arity(key)
    n = packed.shape[2]
    assert packed.shape == (n_in, NLIMBS, n)
    inp = np.ascontiguousarray(packed)
    got = np.zeros((n_out, NLIMBS, n), dtype=np.int64)
    faults = host_fn(lib, key, group)(inp.ctypes.data, got.ctypes.data, n)
    assert faults == 0, f"{faults} bound checks failed in the host build"

    args = FK.args_from_leaves(
        key, [CV.from_numpy(packed[i], *bounds) for i in range(n_in)])
    want = L.tree_leaves(FK.fused_op(FK.signature(key)[0], key, *args))
    assert len(want) == n_out
    for i, w in enumerate(want):
        g = L.to_ints(got[i])
        assert all(int(v) < min(w.vmax, P) for v in g), (key, i)  # canonical
        assert int(got[i].max()) < w.lmax and int(got[i].min()) >= 0
        assert [int(v) for v in g] == [int(v) % P for v in L.to_ints(w)]
    return want


@pytest.mark.parametrize("key", sorted(FK.KERNELS))
def test_host_body_matches_plain_by_value(host_lib, key):
    rng = np.random.default_rng(sorted(FK.KERNELS).index(key) + 41)
    check_against_plain(host_lib, key, boundary_limbs(rng, FK.arity(key)[0]))


def test_host_load_carries_lazy_limbs(host_lib):
    """Inputs beyond the pins (limbs up to 2^20, values up to 2^263), as a
    standalone Fq12 op may get them, are carried by the kernels' load."""
    rng = np.random.default_rng(47)
    x = rng.integers(0, 1 << 20, size=(24, NLIMBS, N), dtype=np.int64)
    x[:, NLIMBS - 1] = rng.integers(0, 1 << 7, size=(24, N))
    x[:, :, 0] = (1 << 20) - 1
    x[:, NLIMBS - 1, 0] = (1 << 7) - 1
    vals = L.to_ints(np.moveaxis(x, 1, 0))
    assert max(int(v) for v in vals.reshape(-1)) < 1 << 263
    check_against_plain(host_lib, "fq12_mul", x, (1 << 263, 1 << 20))


def glv_edge_lanes(rng):
    """(6, 18, 5) limbs of glv_dbl_add's edge lanes: lane 0 has acc the
    identity (Z = 0), lane 1 sel the identity, lane 2 both, with random X
    and Y (the last select, p1, wins); lane 3 adds sel = 2acc (the doubling
    branch), lane 4 adds sel = -2acc (P + (-P), the identity)."""
    x = boundary_limbs(rng, 6)
    x[2, :, 0] = 0  # acc.z
    x[5, :, 1] = 0  # sel.z
    x[[0, 1, 3, 4], :, 2] = SM.bounded_limbs(rng, *PINNED, 8)[:, 4:].T
    acc = J.JPoint(*[CV.from_numpy(x[i], *PINNED) for i in range(3)])
    d = [L.canon(e).arr.numpy() for e in J.double(FqOps, acc)]
    neg_dy = L.canon(L.neg_mod(J.double(FqOps, acc).y)).arr.numpy()
    for i in range(3):
        x[3 + i, :, 3] = d[i][:, 3]
        x[3 + i, :, 4] = (d[0], neg_dy, d[2])[i][:, 4]
    return x


def test_host_glv_step_edge_cases(host_lib):
    """The complete addition's selects (`glv_edge_lanes`) through the
    cooperative host build at every group size G."""
    x = glv_edge_lanes(np.random.default_rng(48))
    sel_z = [int(v) % P for v in L.to_ints(x[5])]
    for group in FK.INSTANCES["glv_dbl_add"]:
        out = check_against_plain(host_lib, "glv_dbl_add", x, group=group)
        z = [int(v) % P for v in L.to_ints(out[2])]
        assert z[2] == 0 and z[4] == 0 and z[3] != 0
        assert z[0] == sel_z[0]  # acc at infinity: the sum is sel


def g1_jac(pt, lam):
    """Host Jacobian G1 point `pt` (Z = 1, or 0 for the identity) in the
    representation with Z scaled by lam."""
    x, y, z = pt
    return (x * lam * lam % P, y * lam ** 3 % P, z * lam % P)


G1_ADD_EDGES = ("p1 identity", "p2 identity", "both identities",
                "p1 == p2", "p1 == -p2", "generic")


def g1_add_edge_lanes():
    """(p1, p2) host Jacobian pairs, one a lane of `G1_ADD_EDGES`, each
    point in its own Jacobian representation (Z != 1)."""
    a = HC.g1_to_affine(HC.g1_mul(HC.G1_ONE, 0xA11CE))
    b = HC.g1_to_affine(HC.g1_mul(HC.G1_ONE, 0xB0B))
    pa, pb = (a[0], a[1], 1), (b[0], b[1], 1)
    ident = (7, 11, 0)  # Z = 0, other coordinates arbitrary
    neg_a = (a[0], P - a[1], 1)
    return [(ident, g1_jac(pb, 5)), (g1_jac(pa, 3), ident),
            (ident, g1_jac(ident, 9)), (g1_jac(pa, 3), g1_jac(pa, 17)),
            (g1_jac(pa, 3), g1_jac(neg_a, 19)), (g1_jac(pa, 3), g1_jac(pb, 5))]


def test_host_g1_add_edge_cases(host_lib):
    """The tree-sum level's complete addition on its edge lanes
    (`G1_ADD_EDGES`) through the cooperative host build at every group
    size G, by canonical value and the declared bounds against the plain
    body, and the sums against the host oracle."""
    pairs = g1_add_edge_lanes()
    x = np.stack([L.to_mont(L.from_ints([pr[k][c] for pr in pairs])).arr
                  .numpy() for k in range(2) for c in range(3)])
    for group in FK.INSTANCES["g1_add"]:
        out = check_against_plain(host_lib, "g1_add", x, group=group)
        got = [tuple(int(v) for v in col) for col in zip(*[
            L.to_ints(L.from_mont(L.canon(e))) for e in out])]
        for edge, (p1, p2), s in zip(G1_ADD_EDGES, pairs, got):
            want = HC.g1_add(p1, p2)
            assert HC.g1_eq(s, want), (edge, group)
            assert (s[2] == 0) == (edge in ("both identities", "p1 == -p2"))


LAZY = (1 << 262, 1 << 20)


@pytest.mark.parametrize("key, bounds", [
    pytest.param("el_pow_step_mul", PINNED, id="pins"),
    pytest.param("el_pow_step_mul", LAZY, id="lazy"),
    pytest.param("el_pow_step_sq", PINNED, id="sq-pins"),
    pytest.param("el_pow_step_sq", LAZY, id="sq-lazy")])
def test_host_pow_step_mul(host_lib, key, bounds):
    """The pow windows' one chain of cios_wide products (el_pow_step_mul,
    and el_pow_step_sq with the multiply off) against `_pow_step_mul` and
    `_pow_step_sq`, at the pins and on lazy inputs (values < 2^262, limbs
    < 2^20, carried by the load)."""
    rng = np.random.default_rng(61)
    x = np.stack([SM.bounded_limbs(rng, *bounds, N)
                  for _ in range(FK.arity(key)[0])])
    check_against_plain(host_lib, key, x, bounds)


def test_host_pow_step_sq_matches_jax(host_lib):
    """el_pow_step_sq against the JAX package's `_pow_step_sq` on the same
    numpy inputs at the pins, by value."""
    import jax.numpy as jnp
    from bn254_tpu.fields import limbs as JL

    x = SM.bounded_limbs(np.random.default_rng(67), *PINNED, N)
    want = JL._pow_step_sq(JL.El(jnp.asarray(x.astype(np.uint32)), *PINNED))
    got = np.zeros((1, NLIMBS, N), dtype=np.int64)
    assert host_fn(host_lib, "el_pow_step_sq")(
        np.ascontiguousarray(x).ctypes.data, got.ctypes.data, N) == 0
    assert [int(v) for v in L.to_ints(got[0])] == \
        [int(v) % P for v in JL.to_ints(want.arr)]


def leaf_operands(kind, rng, n=64):
    """(a, b) limbs for the leaf: random within the contract (limbs <
    2^16, a b + R p < 2^538); boundary lanes (`samples.bounded_limbs` at
    the pins: the largest value with lazy and with carried limbs, zero),
    one lane times one; or every limb 0x7FFF or 0xFFFF (past the
    contract's value bound: the three leaves still agree, as each keeps
    its columns exact and drops the same final carry)."""
    if kind in (0x7FFF, 0xFFFF):
        a = np.full((NLIMBS, n), kind, dtype=np.int64)
        return a, a.copy()
    if kind == "boundary":
        a, b = (SM.bounded_limbs(rng, *PINNED, n) for _ in range(2))
        b[:, 3] = 0
        b[0, 3] = 1
        return a, b
    a = rng.integers(0, 1 << 16, size=(NLIMBS, n), dtype=np.int64)
    b = rng.integers(0, 1 << 16, size=(NLIMBS, n), dtype=np.int64)
    a[NLIMBS - 1] = rng.integers(0, 1 << 7, size=n)
    b[NLIMBS - 1] = rng.integers(0, 1 << 7, size=n)
    return a, b


@pytest.fixture()
def host_card(host_lib, monkeypatch):
    """`fused_op`'s CUDA path (packing, launch counts, learned bounds) with
    the host build standing in for the card; returns `counted(**want)`,
    which compares and resets the nonzero launch counts."""
    def launch(key, packed, out):
        fn = host_fn(host_lib, key)
        assert fn(packed.data_ptr(), out.data_ptr(), packed.shape[2]) == 0

    monkeypatch.setattr(T, "_on_card", lambda els: True)
    monkeypatch.setattr(FK, "_on_cuda", lambda els: True)
    monkeypatch.setattr(FK, "_launch", launch)
    monkeypatch.setattr(FK, "launches", dict.fromkeys(FK.KERNELS, 0))

    def counted(**want):
        got = {k: v for k, v in FK.launches.items() if v}
        FK.launches.update(dict.fromkeys(FK.launches, 0))
        return got == want

    return counted


@pytest.mark.parametrize("key", ["miller_dbl_body2", "miller_add_body2"])
def test_host_pair2_body_with_unbatched_constants(host_card, key):
    """The constant line triple (ca, cb, cc) as unbatched (18,) Els between
    batched operands, as the pair2 loop passes them: each broadcasts in its
    own position."""
    body, _ = FK.signature(key)
    names = list(inspect.signature(body).parameters)
    rng = np.random.default_rng(sorted(FK.KERNELS).index(key) + 51)
    args = list(FK.args_from_leaves(key, [
        CV.from_numpy(x, *PINNED) for x in boundary_limbs(rng, FK.arity(key)[0])]))
    for j, name in enumerate(("ca", "cb", "cc")):
        i = names.index(name)
        args[i] = L.tree_map(lambda e: L.El(e.arr[:, 3 + j % 2], e.vmax, e.lmax),
                             args[i])
        assert args[i].c0.arr.shape == (NLIMBS,)
    got = FK.fused_op(body, key, *args)
    assert host_card(**{key: 1})
    with FK.kernel_mode():
        want = body(*args)
    for g, w in zip(L.tree_leaves(got), L.tree_leaves(want)):
        assert g.arr.shape == (NLIMBS, N) and (g.vmax, g.lmax) == (w.vmax, w.lmax)
        assert int(g.arr.max()) < 1 << 15 and int(g.arr.min()) >= 0
        assert ([int(v) for v in L.to_ints(g)]
                == [int(v) % P for v in L.to_ints(w)])


def test_pair2_loop_through_the_host_kernels(host_card, monkeypatch):
    """The pair2 loop on a 3-digit schedule (both signs, a zero digit, both
    Frobenius steps), one launch per digit, by value against the product of
    the two pairs' plain scan-form Miller values;
    each body learns ONE output template: the pinned constants carry the
    batched operands' (2^262, 2^16)."""
    monkeypatch.setattr(FK, "_out_structs", {})
    g1 = [HC.g1_mul(HC.G1_ONE, 5 + i) for i in range(4)]
    g2 = [HC.g2_mul(HC.G2_ONE, 9 + i) for i in range(2)]
    hx, hy = CV.g1_batch_to_device_affine(g1[:2])
    sx, sy = CV.g1_batch_to_device_affine(g1[2:])
    qx, qy = CV.g2_batch_to_device_affine(g2)
    naf = (1, 0, -1)
    coeffs = PC.g2_line_coeffs(HC.g2_to_affine(HC.g2_neg(HC.G2_ONE)), naf=naf)
    f = M._miller_loop_pair2_unrolled(hx, hy, qx, qy, sx, sy, coeffs, naf=naf)
    assert host_card(miller_dbl_body2=3, miller_add_body2=4)
    ngx, ngy = CV.g2_const_affine(HC.g2_neg(HC.G2_ONE), (2,))
    with FK.kernel_mode():  # the two pairs stacked through the scan form
        both = M._miller_loop_scan(
            L.stack([hx, sx]), L.stack([hy, sy]), T.fq2_stack([qx, ngx]),
            T.fq2_stack([qy, ngy]), naf=naf)
        f0, f1 = (L.tree_map(lambda e: L.El(e.arr[:, i], e.vmax, e.lmax),
                             both) for i in range(2))
        assert bool(T.fq12_eq(f, T.fq12_mul(f0, f1)).all())
    learned = [fn.__name__ for fn, _ in FK._out_structs]
    assert sorted(learned) == ["_add_body2_impl", "_dbl_body2_impl"]


def test_loops_through_the_host_kernels(host_card):
    """The CUDA path of `fused_op` with the host build standing in for the
    card: the unrolled Miller loop on a 3-digit schedule (both signs, a zero
    digit, both Frobenius steps), exp_u on 4 windows (two zero, two nonzero)
    with its table, the easy part, a full p - 2 power and a 4-step GLV
    ladder, by value against the plain forms; the full schedules' launches
    are counted on the card by chip_smoke.py and on the CPU by
    tests/test_torch_verify.py."""
    counted = host_card
    g1 = [HC.g1_mul(HC.G1_ONE, 5 + i) for i in range(2)]
    g2 = [HC.g2_mul(HC.G2_ONE, 9 + i) for i in range(2)]
    px, py = CV.g1_batch_to_device_affine(g1)
    qx, qy = CV.g2_batch_to_device_affine(g2)
    naf = (1, 0, -1)
    f = M.miller_loop(px, py, qx, qy, naf=naf)
    assert counted(miller_dbl_body=3, miller_add_body=4)
    with FK.kernel_mode():
        want = M._miller_loop_scan(px, py, qx, qy, naf=naf)
    assert bool(T.fq12_eq(f, want).all())

    cyc = T.fq12_retag(FE.easy_part(T.fq12_retag(want)))
    bits = bin(P - 2)[2:]  # one Fp inversion: 3-bit windows after the lead
    wins = [bits[i:i + 3] for i in range(len(bits) % 3 or 3, len(bits), 3)]
    nonzero = sum(int(b, 2) != 0 for b in wins)
    assert counted(fq12_mul=2, el_pow_step_mul=nonzero,
                   el_pow_step_sq=len(wins) - nonzero)
    with FK.kernel_mode():
        assert bool(T.fq12_eq(cyc, FE.easy_part(T.fq12_retag(want))).all())
    windows = FE._U_WINDOWS[:4]
    u = FE.exp_u(cyc, windows)
    assert counted(expu_step=2, expu_sq2=2, fq12_cyc_sq=1, fq12_mul=1)
    with FK.kernel_mode():
        assert bool(T.fq12_eq(u, FE._exp_u_scan(cyc, windows)).all())
    for e in L.tree_leaves(u):
        assert (e.vmax, e.lmax) == (L.STD_BOUND, 1 << 16)
        assert int(e.arr.max()) < 1 << 15  # the kernels return carried limbs

    p = J.JPoint(px, py, L.mont_one((2,)))
    w = GLV.glv_weights_to_device([(0b1011, 0b0110), (0b0001, 0b1111)], 8)
    got = GLV.shamir_scalar_mul(p, w)
    assert counted(glv_dbl_add=4)
    with FK.kernel_mode():
        ref = GLV.shamir_scalar_mul(p, w)
    assert bool(same_point(got, ref).all())


def test_scan_loop_through_the_host_kernels(host_card, monkeypatch):
    """`config.unroll_static_loops` off: the scan-form Miller loop on a
    3-digit schedule through the per-op kernels at the bounds the loop
    really feeds them (unpinned step and line outputs, `fq12_sq`'s
    template), by value against the plain scan loop."""
    from bn254_tpu_torch import config as C

    monkeypatch.setattr(C, "DEFAULT", C.DEFAULT.replace(
        unroll_static_loops=False))
    g1 = [HC.g1_mul(HC.G1_ONE, 5 + i) for i in range(2)]
    g2 = [HC.g2_mul(HC.G2_ONE, 9 + i) for i in range(2)]
    px, py = CV.g1_batch_to_device_affine(g1)
    qx, qy = CV.g2_batch_to_device_affine(g2)
    naf = (1, 0, -1)
    f = M.miller_loop(px, py, qx, qy, naf=naf)
    assert host_card(fq12_sq=3, g2_dbl_step=3, g2_add_step=4,
                     fq12_mul_line=7)
    with FK.kernel_mode():
        want = M._miller_loop_scan(px, py, qx, qy, naf=naf)
    assert bool(T.fq12_eq(f, want).all())


def same_point(a, b):
    """Projective equality of Jacobian G1 points (X1 Z2^2 == X2 Z1^2, ...)."""
    z1, z2 = L.mont_sqr(a.z), L.mont_sqr(b.z)
    x = L.eq(L.mont_mul(a.x, z2), L.mont_mul(b.x, z1))
    y = L.eq(L.mont_mul(L.mont_mul(a.y, z2), b.z),
             L.mont_mul(L.mont_mul(b.y, z1), a.z))
    return x & y


@pytest.mark.parametrize("kind", ["random", "boundary", 0x7FFF, 0xFFFF],
                         ids=["random", "boundary", "all-7fff", "all-ffff"])
def test_host_wide_leaf_is_bit_exact(host_lib, kind):
    """cios_wide (64-bit columns) equals cios and montmul_plain limb for
    limb."""
    a, b = leaf_operands(kind, np.random.default_rng(9))
    n = a.shape[1]
    outs = {}
    for name in ("bn254_host_cios", "bn254_host_cios_wide"):
        fn = getattr(host_lib, name)
        fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
        fn.restype = None
        outs[name] = np.zeros((NLIMBS, n), dtype=np.int64)
        fn(np.ascontiguousarray(a).ctypes.data,
           np.ascontiguousarray(b).ctypes.data, outs[name].ctypes.data, n)
    want = MK.montmul_plain(torch.from_numpy(a), torch.from_numpy(b)).numpy()
    assert np.array_equal(outs["bn254_host_cios_wide"], want)
    assert np.array_equal(outs["bn254_host_cios"], want)


def test_host_leaf_is_bit_exact_with_montmul_plain(host_lib):
    rng = np.random.default_rng(7)
    n = 64
    a = rng.integers(0, 1 << 16, size=(NLIMBS, n), dtype=np.int64)
    b = rng.integers(0, 1 << 16, size=(NLIMBS, n), dtype=np.int64)
    a[NLIMBS - 1] = rng.integers(0, 1 << 7, size=n)  # a*b + R p < 2^538
    b[NLIMBS - 1] = rng.integers(0, 1 << 7, size=n)
    out = np.zeros((NLIMBS, n), dtype=np.int64)
    host_lib.bn254_host_cios.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int64]
    host_lib.bn254_host_cios.restype = None
    host_lib.bn254_host_cios(a.ctypes.data, b.ctypes.data, out.ctypes.data, n)
    want = MK.montmul_plain(torch.from_numpy(a), torch.from_numpy(b))
    assert np.array_equal(out, want.numpy())
