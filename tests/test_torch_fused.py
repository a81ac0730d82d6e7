"""The port's fused bodies and unrolled loops vs the JAX package.

Inputs are made from numpy seeds and reach both packages through the
carry-across functions (`utils.convert.from_numpy` and
`kernels.fused.args_from_leaves`). Limbs are compared with
`np.array_equal`, together with the (vmax, lmax) bounds, unless a test says
"by value":

* the sixteen plain bodies against JAX's same `_impl` at B=3 (`g1_add`
  against its complete add, pinned), inputs at the pinned / retagged
  bounds (2^262, 2^16);
* `_miller_loop_unrolled(naf=(1, -1))`, Frobenius steps included,
  `_exp_u_unrolled` over one zero and one nonzero window, `_pow_fixed_fused`
  on an exponent with zero and nonzero windows and `_shamir_unrolled` over
  4 steps, against JAX's unrolled forms with its `fused_op` routed to one
  `jax.jit` per body (the `jit_routed_bodies` pattern of
  tests/test_bound_pinning.py);
* by value, the port's unrolled forms against its scan forms on the full
  schedules;
* `fused_op` itself on the CPU: learned bounds, broadcasting, and the
  refusals of its CUDA path.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from bn254_tpu.curve import g1 as JG1
from bn254_tpu.curve import glv as JGLV
from bn254_tpu.curve import jacobian as JJ
from bn254_tpu.fields import limbs as JL
from bn254_tpu.fields import tower as JT
from bn254_tpu.host import curve as JHC
from bn254_tpu.host import field as HF
from bn254_tpu.kernels import fused as JFK
from bn254_tpu.pairing import final_exp as JFE
from bn254_tpu.pairing import miller as JM
from bn254_tpu.utils import convert as JCV
from bn254_tpu_torch.constants import NLIMBS, P
from bn254_tpu_torch.curve import glv as GLV
from bn254_tpu_torch.curve import jacobian as J
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.fields import tower as T
from bn254_tpu_torch.kernels import fused as FK
from bn254_tpu_torch.pairing import final_exp as FE
from bn254_tpu_torch.pairing import miller as M
from bn254_tpu_torch.utils import convert as CV

STD = L.STD_BOUND


def jax_g1_add(x1, y1, z1, x2, y2, z2):
    """The JAX package's complete add on Fq with its outputs pinned as its
    GLV ladder step pins them: the package has no body for one tree-sum
    level, which it adds leaf by leaf."""
    out = JG1.add(JJ.JPoint(x1, y1, z1), JJ.JPoint(x2, y2, z2))
    return tuple(JGLV._pin(c) for c in out)


# key -> the JAX package's body of the same kernel
JAX_BODIES = {
    "miller_dbl_body": JM._dbl_body_impl,
    "miller_add_body": JM._add_body_impl,
    "miller_dbl_body2": JM._dbl_body2_impl,
    "miller_add_body2": JM._add_body2_impl,
    "expu_step": JFE._expu_step_impl,
    "expu_sq2": JFE._expu_sq2_impl,
    "fq12_mul": JT._fq12_mul_impl,
    "fq12_sq": JT._fq12_sq_impl,
    "fq12_cyc_sq": JT._fq12_cyc_sq_impl,
    "el_pow_step_mul": JL._pow_step_mul,
    "el_pow_step_sq": JL._pow_step_sq,
    "glv_dbl_add": JGLV._dbl_add_body_impl,
    "fq12_mul_line": JM._fq12_mul_line_impl,
    "g2_dbl_step": JM._dbl_step_impl,
    "g2_add_step": JM._add_step_impl,
    "g1_add": jax_g1_add,
}

# the port's tree types -> the JAX package's
_JAX_TYPES = {T.Fq2: JT.Fq2, T.Fq6: JT.Fq6, T.Fq12: JT.Fq12,
              M.ProjG2: JM.ProjG2, J.JPoint: JJ.JPoint}


def to_jax(x):
    """A port value tree -> the same limbs and bounds as a JAX value tree."""
    if isinstance(x, L.El):
        return JL.El(jnp.asarray(x.arr.numpy().astype(np.uint32)), x.vmax,
                     x.lmax)
    kids = [to_jax(c) for c in x]
    return tuple(kids) if type(x) is tuple else _JAX_TYPES[type(x)](*kids)


def leaves(x):
    return [x] if hasattr(x, "vmax") else [e for c in x for e in leaves(c)]


def parts(x):
    return [(np.asarray(e.arr), e.vmax, e.lmax) for e in leaves(x)]


def assert_same(jx, px):
    jl, pl = leaves(jx), leaves(px)
    assert len(jl) == len(pl)
    for j, p in zip(jl, pl):
        assert (p.vmax, p.lmax) == (j.vmax, j.lmax)
        assert np.array_equal(np.asarray(j.arr).astype(np.int64),
                              p.arr.numpy())


def canon_values(x):
    return [[int(v) % P for v in L.to_ints(e).reshape(-1)] for e in leaves(x)]


def lazy_limbs(rng, n_els, batch):
    """Random (n_els, 18, batch) limbs < 2^16 with values < 2^262."""
    x = rng.integers(0, 1 << 16, size=(n_els, NLIMBS, batch), dtype=np.int64)
    x[:, NLIMBS - 1] = rng.integers(0, 126, size=(n_els, batch))
    return x


def body_args(key, limbs):
    """The body's arguments from (n_in, 18, *batch) limbs at the pins."""
    return FK.args_from_leaves(
        key, [CV.from_numpy(x, STD, 1 << 16) for x in limbs])


@pytest.mark.parametrize("key", sorted(FK.KERNELS))
def test_plain_body_matches_jax(key):
    rng = np.random.default_rng(sorted(FK.KERNELS).index(key) + 1)
    args = body_args(key, lazy_limbs(rng, FK.arity(key)[0], 3))
    want = JAX_BODIES[key](*to_jax(args))
    assert_same(want, FK.signature(key)[0](*args))


@pytest.fixture()
def jax_routed(monkeypatch):
    """JAX's fused_op -> one jax.jit per body (its kernels' plain form)."""
    routed = {}

    def plain(fn, key, *args, interpret=False):
        if key not in routed:
            routed[key] = jax.jit(fn)
        return routed[key](*args)

    monkeypatch.setattr(JFK, "fused_op", plain)


def g1_g2_batch(seed, n=2):
    g1 = [JHC.g1_mul(JHC.G1_ONE, seed + 2 * i) for i in range(n)]
    g2 = [JHC.g2_mul(JHC.G2_ONE, seed + 3 + i) for i in range(n)]
    return JCV.g1_batch_to_device_affine(g1), JCV.g2_batch_to_device_affine(g2)


def test_miller_unrolled_matches_jax(jax_routed):
    (px, py), (qx, qy) = g1_g2_batch(3)
    naf = (1, -1)  # both add signs; the two Frobenius adds always run
    want = JM._miller_loop_unrolled(px, py, qx, qy, naf=naf)
    el = lambda e: CV.from_numpy(*parts(e)[0])
    got = M._miller_loop_unrolled(el(px), el(py), CV.fq2_from_numpy(parts(qx)),
                                  CV.fq2_from_numpy(parts(qy)), naf=naf)
    assert_same(want, got)


def easy_part_images(seed, n):
    """n cyclotomic Fq12 host values (easy-part images)."""
    rng = np.random.default_rng(seed)
    hs = []
    for _ in range(n):
        f = tuple(tuple((int(rng.integers(1, 2**62)) ** 4 % P,
                         int(rng.integers(1, 2**62)) ** 4 % P)
                        for _ in range(3)) for _ in range(2))
        g = HF.fq12_mul(HF.fq12_conj(f), HF.fq12_inv(f))
        hs.append(HF.fq12_mul(HF.fq12_frob(g, 2), g))
    return [JL.to_mont(JL.from_ints([h[i][j][k] for h in hs]))
            for i in range(2) for j in range(3) for k in range(2)]


def test_exp_u_unrolled_matches_jax(jax_routed):
    f = CV.fq12_from_numpy([(np.asarray(e.arr), e.vmax, e.lmax)
                            for e in easy_part_images(20260821, 2)])
    windows = tuple(JFE._U_WINDOWS[:2])
    assert 0 in windows and any(windows)
    want = JFE._exp_u_unrolled(to_jax(f), windows=windows)
    assert_same(want, FE._exp_u_unrolled(f, windows=windows))


def test_pow_fixed_fused_matches_jax(jax_routed):
    """A 13-bit exponent: a 1-bit lead window, then 011 000 101 110."""
    bits = "1011000101110"
    rng = np.random.default_rng(11)
    base = CV.from_numpy(lazy_limbs(rng, 1, 3)[0], STD, 1 << 16)
    want = JL._pow_fixed_fused(to_jax(base), tuple(int(b) for b in bits[1:]))
    assert_same(want, L._pow_fixed_fused(base, bits))


def test_shamir_unrolled_matches_jax(jax_routed):
    (px, py), _ = g1_g2_batch(5)
    pairs = [(0b1011, 0b0110), (0b0001, 0b1111)]
    jp = JJ.JPoint(px, py, JL.mont_one((2,)))
    want = JGLV._shamir_unrolled(JGLV._table(jp),
                                 JGLV.glv_weights_to_device(pairs, 8), 4)
    p = J.JPoint(*[CV.from_numpy(*q) for q in parts(jp)])
    got = GLV._shamir_unrolled(GLV._table(p),
                               GLV.glv_weights_to_device(pairs, 8), 4)
    assert_same(want, got)


def test_unrolled_matches_scan_full_schedules():
    """By value: the full Miller schedule at B=2, the full exp_u, a full
    p - 2 power and a 64-step GLV ladder."""
    (px, py), (qx, qy) = g1_g2_batch(11)
    px, py = CV.from_numpy(*parts(px)[0]), CV.from_numpy(*parts(py)[0])
    qx, qy = CV.fq2_from_numpy(parts(qx)), CV.fq2_from_numpy(parts(qy))
    f = M._miller_loop_unrolled(px, py, qx, qy)
    assert canon_values(f) == canon_values(M._miller_loop_scan(px, py, qx, qy))

    cyc = T.fq12_retag(FE.easy_part(T.fq12_retag(f)))
    assert (canon_values(FE._exp_u_unrolled(cyc))
            == canon_values(FE._exp_u_scan(cyc)))

    x = f.c0.c0.c0
    inv = L._pow_fixed_fused(L.retag(L.norm_limbs(x), STD), bin(P - 2)[2:])
    assert canon_values(inv) == canon_values(L.inv_mod(x))

    p = J.JPoint(px, py, L.mont_one((2,)))
    w = GLV.glv_weights_to_device([(2**64 - 1, 3**40), (1, 2**63)], 128)
    table = GLV._table(p)
    unrolled = GLV._shamir_unrolled(table, w, 64)
    scan = GLV._shamir_scan(table, w, 64)
    assert canon_values(unrolled) == canon_values(scan)


def test_fused_op_cpu_calls_the_plain_body_and_learns_its_bounds():
    rng = np.random.default_rng(3)
    key = "miller_add_body"
    body = FK.signature(key)[0]
    args = body_args(key, lazy_limbs(rng, 24, 2))
    before = dict(FK.launches)
    got = FK.fused_op(body, key, *args)
    assert FK.launches == before  # the CPU path launches nothing
    want = body(*args)
    assert_same(want, got)
    template = FK._out_struct(
        body, tuple((e.vmax, e.lmax) for e in leaves(args)), args)
    bounds = tuple((e.vmax, e.lmax) for e in leaves(template))
    assert bounds == tuple((e.vmax, e.lmax) for e in leaves(want))
    assert bounds == ((STD, 1 << 16),) * 18
    assert type(template) is tuple and isinstance(template[1], M.ProjG2)


def test_fused_op_cpu_runs_the_body_in_kernel_mode(monkeypatch):
    """Tower ops inside a body do not dispatch again, even where kernels are
    forced on (as on the card: one launch per body, not one per op)."""
    monkeypatch.setattr(T, "_on_card", lambda els: True)
    calls = []
    fused_op = FK.fused_op

    def counted(fn, key, *args):
        calls.append(key)
        return fused_op(fn, key, *args)

    monkeypatch.setattr(FK, "fused_op", counted)
    f = body_args("expu_sq2", lazy_limbs(np.random.default_rng(6), 12, 2))[0]
    FE.exp_u(f, (0,))  # the table's fq12_cyc_sq, fq12_mul, then one window
    assert calls == ["fq12_cyc_sq", "fq12_mul", "expu_sq2"]
    with FK.kernel_mode():
        T.fq12_sq(f)
        assert not T._use_kernels(f.c0.c0.c0)
    assert len(calls) == 3


def test_pack_broadcasts_an_unbatched_operand():
    rng = np.random.default_rng(4)
    c = CV.from_numpy(lazy_limbs(rng, 1, 1)[0, :, 0], STD, 1 << 16)  # (18,)
    x = CV.from_numpy(lazy_limbs(rng, 1, 5)[0], STD, 1 << 16)  # (18, 5)
    y = CV.from_numpy(lazy_limbs(rng, 1, 5)[0][:, None, :].repeat(2, 1),
                      STD, 1 << 16)  # (18, 2, 5) against (18, 2, 1)
    packed, batch = FK.pack([c, x])
    assert batch == (5,) and packed.shape == (2, NLIMBS, 5)
    assert (packed[0] == c.arr[:, None]).all() and (packed[1] == x.arr).all()
    z = CV.from_numpy(lazy_limbs(rng, 1, 2)[0], STD, 1 << 16)  # (18, 2)
    packed, batch = FK.pack([z, y])
    assert batch == (2, 5) and packed.shape == (2, NLIMBS, 10)
    assert (packed[0].reshape(NLIMBS, 2, 5) == z.arr[:, :, None]).all()
    # the plain body takes the same (18,) operand on the CPU
    acc = body_args("expu_sq2", [lazy_limbs(rng, 1, 1)[0, :, 0]] * 12)[0]
    assert FK.fused_op(FE._expu_sq2_impl, "expu_sq2",
                       acc).c0.c0.c0.arr.shape == (NLIMBS,)


def test_cuda_path_refusals(monkeypatch):
    """On the CUDA path: a key without a kernel, an input beyond the
    kernels' (2^270, 2^26) and a body declaring an output bound below a
    canonical value's raise."""
    monkeypatch.setattr(FK, "_on_cuda", lambda els: True)
    rng = np.random.default_rng(5)
    f = body_args("fq12_sq", lazy_limbs(rng, 12, 2))[0]
    with pytest.raises(NotImplementedError, match="fq12_conj"):
        FK.fused_op(T.fq12_conj, "fq12_conj", f)
    wide = L.tree_map(lambda e: L.El(e.arr, 1 << 271, e.lmax), f)
    with pytest.raises(ValueError, match="exceeds"):
        FK.fused_op(FE._expu_sq2_impl, "expu_sq2", wide)
    small = L.El(f.c0.c0.c0.arr, P, 1 << 15)
    with pytest.raises(ValueError, match="below a canonical"):
        FK.fused_op(lambda acc: L.El(acc.arr, P - 1, acc.lmax),
                    "el_pow_step_sq", small)
