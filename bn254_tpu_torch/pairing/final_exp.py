"""Final exponentiation f^((p^12-1)/r) for BN254.

Counterpart of `bn254_tpu/pairing/final_exp.py` in the form its batch
verifiers run: the staged pipeline `final_exp_staged` (easy part, three
u-exponentiations, hard-part combination, each stage retagging its own
output). `exp_u` has the JAX package's two forms: unrolled, one fused CUDA
kernel per window (kernels/fused.py; the form CUDA tensors take under
`config.unroll_static_loops`), and the scan form (CPU tensors, and CUDA
tensors with the knob off: two `fq12_cyc_sq` and one `fq12_mul` launch per
window). The JAX package's replicated-block trick for
scalar inputs (`final_exp_wide`) works around slow batch-1 programs on the
TPU and is not carried over: a scalar final exponentiation here runs on
(18,) tensors.

Easy part (p^6-1)(p^2+1), then the Devegili-style hard-part chain.
"""

from __future__ import annotations

from .. import obs
from ..constants import U
from ..fields import limbs as L
from ..fields import tower as T
from ..kernels import fused as FK

Fq12 = T.Fq12

_U_BITS = [int(b) for b in bin(U)[2:]][1:]  # MSB consumed by init
assert len(_U_BITS) % 2 == 0  # 62 bits -> 31 two-bit windows
_U_WINDOWS = [
    2 * _U_BITS[i] + _U_BITS[i + 1] for i in range(0, len(_U_BITS), 2)
]


def _expu_step_impl(acc: Fq12, m: Fq12) -> Fq12:
    """(acc^4) * m — one nonzero window (kernel "expu_step")."""
    acc = T.fq12_cyc_sq(acc)
    acc = T.fq12_cyc_sq(T.fq12_retag(acc))
    acc = T.fq12_mul(T.fq12_retag(acc), m)
    return T.fq12_retag(acc)


def _expu_sq2_impl(acc: Fq12) -> Fq12:
    """acc^4 — one zero window (kernel "expu_sq2")."""
    acc = T.fq12_cyc_sq(acc)
    acc = T.fq12_cyc_sq(T.fq12_retag(acc))
    return T.fq12_retag(acc)


def _exp_u_table(f: Fq12):
    f = T.fq12_retag(f)
    f2 = T.fq12_retag(T.fq12_cyc_sq(f))
    f3 = T.fq12_retag(T.fq12_mul(f2, f))
    return f, f2, f3


def _exp_u_unrolled(f: Fq12, windows=None) -> Fq12:
    """exp_u unrolled over the static windows of u: one `expu_step` launch
    per nonzero window, which folds its table entry in the same launch, and
    one `expu_sq2` per zero window, which skips the multiply (31 launches
    on the full schedule). windows: schedule override for tests."""
    f, f2, f3 = _exp_u_table(f)
    table = {1: f, 2: f2, 3: f3}
    acc = f  # the MSB of u is consumed by the init (as in the scan form)
    for w in (_U_WINDOWS if windows is None else windows):
        if w:
            acc = FK.fused_op(_expu_step_impl, "expu_step", acc, table[w])
        else:
            acc = FK.fused_op(_expu_sq2_impl, "expu_sq2", acc)
    return acc


def _exp_u_scan(f: Fq12, window_digits=None) -> Fq12:
    """The leaf-level loop, the counterpart of JAX's `_exp_u_scan`: per
    window two Granger-Scott squarings and one multiply by the table entry
    {1, f, f^2, f^3}[digit]. A zero window multiplies by `one`, as the JAX
    scan does, so the limbs match it one for one."""
    e = f.c0.c0.c0
    f, f2, f3 = _exp_u_table(f)
    one = T.fq12_retag(T.fq12_one(e.batch_shape, e.device))
    table = (one, f, f2, f3)

    acc = f
    for w in (_U_WINDOWS if window_digits is None else window_digits):
        acc = T.fq12_cyc_sq(acc)
        acc = T.fq12_cyc_sq(T.fq12_retag(acc))
        acc = T.fq12_retag(T.fq12_mul(T.fq12_retag(acc), table[w]))
    return acc


def exp_u(f: Fq12, window_digits=None) -> Fq12:
    """f^u for a CYCLOTOMIC f (all final-exp call sites qualify): 2-bit
    windowed square-and-multiply over the fixed bits of u. Unrolled into
    fused kernels on CUDA tensors under `config.unroll_static_loops`, the
    scan form otherwise.

    window_digits: schedule override (tests use a truncated prefix).
    """
    from .. import config as C

    if C.DEFAULT.unroll_static_loops and T._use_kernels(*L.tree_leaves(f)):
        return _exp_u_unrolled(f, window_digits)
    return _exp_u_scan(f, window_digits)


def easy_part(f: Fq12) -> Fq12:
    """f^((p^6-1)(p^2+1)) — lands in the cyclotomic subgroup."""
    f = T.fq12_mul(T.fq12_conj(f), T.fq12_inv(f))  # f^(p^6-1)
    return T.fq12_mul(T.fq12_frob(f, 2), f)  # ^(p^2+1)


def hard_combine(f: Fq12, ft1: Fq12, ft2: Fq12, ft3: Fq12) -> Fq12:
    """Hard part (p^4-p^2+1)/r given f (cyclotomic) and its u-powers."""
    fp1 = T.fq12_frob(f, 1)
    fp2 = T.fq12_frob(f, 2)
    fp3 = T.fq12_frob(f, 3)
    y0 = T.fq12_mul(T.fq12_mul(fp1, fp2), fp3)
    y1 = T.fq12_conj(f)
    y2 = T.fq12_frob(ft2, 2)
    y3 = T.fq12_conj(T.fq12_frob(ft1, 1))
    y4 = T.fq12_conj(T.fq12_mul(ft1, T.fq12_frob(ft2, 1)))
    y5 = T.fq12_conj(ft2)
    y6 = T.fq12_conj(T.fq12_mul(ft3, T.fq12_frob(ft3, 1)))
    # every operand here is cyclotomic -> cyclotomic squares
    t0 = T.fq12_mul(T.fq12_mul(T.fq12_cyc_sq(y6), y4), y5)
    t1 = T.fq12_mul(T.fq12_mul(y3, y5), t0)
    t0 = T.fq12_mul(t0, y2)
    t1 = T.fq12_cyc_sq(T.fq12_mul(T.fq12_cyc_sq(T.fq12_retag(t1)), t0))
    return T.fq12_mul(
        T.fq12_mul(t1, y0), T.fq12_cyc_sq(T.fq12_mul(T.fq12_retag(t1), y1))
    )


def _retag_tight(a: Fq12) -> Fq12:
    """Retag with the element's own exact bound instead of STD_BOUND
    (saves cond_sub rounds in the canon of a later is_one)."""
    return T.fq12_retag(a, max(e.vmax for e in L.tree_leaves(a)))


def final_exp(f: Fq12) -> Fq12:
    """The JAX package's `final_exp_staged`: every stage retags its output."""
    with obs.span("final_exp"):
        with obs.span("final_exp.easy"):
            f = T.fq12_retag(easy_part(T.fq12_retag(f)))
        ft = [f]
        for _ in range(3):
            with obs.span("final_exp.exp_u"):
                ft.append(T.fq12_retag(exp_u(ft[-1])))
        with obs.span("final_exp.hard"):
            return _retag_tight(hard_combine(*ft))
