"""Lazy Montgomery limb engine on torch tensors.

Counterpart of `bn254_tpu/fields/limbs.py`, with the same numbers, so that
every function here can be held limb for limb against its JAX twin: field
elements are little-endian **15-bit limbs in tensors of shape
(18, *batch)**, Montgomery radix R = 2^270.

* Limbs are held in **int64**. Torch on the CPU has no add or shift for
  uint32, and a limb product reaches 2^32, so int32 would overflow. Every
  value the JAX package keeps in uint32 stays below 2^32 here too (the
  static bounds guarantee it), so the int64 results are the same limbs.
* **Redundancy buys laziness.** Addition is one tensor op, subtraction is
  one signed carry chain plus a static multiple-of-p offset, REDC has no
  conditional subtract; canonicalisation happens only at compare
  boundaries.
* **Exact static bound tracking.** Every `El` carries its exact value
  bound `vmax` and limb bound `lmax` as Python ints; overflow is a Python
  assertion, costing nothing on the device. The decisions made on them
  (`norm_limbs`, `maybe_vreduce`, the sub offsets) are the JAX package's,
  one for one, which is what keeps the limbs identical.
* `mont_mul` is the leaf multiply. On a CUDA tensor it always launches
  the hand-written CIOS kernel (kernels/montmul.py); on a CPU tensor it
  runs the kernel's plain torch version.
* Every function follows the device of its input tensors. Constants are
  built on that device (`const_el(x, device)`).
"""

from __future__ import annotations

import functools
import typing

import numpy as np
import torch

from ..constants import (
    LIMB_BITS,
    LIMB_MASK,
    MONT_R,
    MONT_R2_MOD_P,
    MONT_R_MOD_P,
    NLIMBS,
    P,
    to_limbs,
)
from ..kernels import montmul as MK

DTYPE = torch.int64
MASK = LIMB_MASK
CAPACITY = 1 << (LIMB_BITS * NLIMBS)  # 2^270
_PROD_LIMIT = 1 << 32  # a_i * b_j must stay below this (uint32 exact)
_COL_LIMIT = 1 << 26  # column values entering a carry chain
# T = a*b + m*p must fit 2*NLIMBS limbs (2^540) with margin
_T_LIMIT = 1 << 538

# standard carrier bound used to stabilise loop carriers (see retag)
STD_BOUND = 1 << 262

# True while a fused body runs as plain code (kernels/fused.py): tower ops
# inside it must not dispatch to kernels of their own (as in JAX)
_KERNEL_MODE = False


# ---------------------------------------------------------------------------
# Element type: tensor + static exact bounds
# ---------------------------------------------------------------------------


class El:
    """A (batched) bigint in limb form with static bounds.

    arr: (NLIMBS, *batch) int64 limbs, little-endian, radix 2^15.
    vmax: exclusive upper bound on the represented value (exact int).
    lmax: exclusive upper bound on every limb (exact int).
    """

    __slots__ = ("arr", "vmax", "lmax")

    def __init__(self, arr: torch.Tensor, vmax: int, lmax: int):
        self.arr = arr
        self.vmax = vmax
        self.lmax = lmax

    @property
    def batch_shape(self) -> tuple:
        return tuple(self.arr.shape[1:])

    @property
    def device(self) -> torch.device:
        return self.arr.device

    def __repr__(self):
        return (f"El(shape={tuple(self.arr.shape)}, device={self.arr.device}, "
                f"vmax=2^{self.vmax.bit_length() - 1}, lmax={self.lmax})")


def tree_map(fn, x):
    """Apply `fn` to every El of a tree of NamedTuples (Fq2, Fq12,
    JPoint...) and plain tuples, depth first."""
    if isinstance(x, El):
        return fn(x)
    kids = [tree_map(fn, c) for c in x]
    return tuple(kids) if type(x) is tuple else type(x)(*kids)


def tree_leaves(x) -> list:
    """The Els of a tree of NamedTuples and tuples, depth first."""
    if isinstance(x, El):
        return [x]
    return [e for c in x for e in tree_leaves(c)]


def tree_from_leaves(tp, leaves):
    """A value of type `tp` (El or a NamedTuple of annotated El trees such
    as Fq12 or ProjG2) built from the iterator `leaves`, depth first."""
    if tp is El:
        return next(leaves)
    hints = typing.get_type_hints(tp)
    return tp(*[tree_from_leaves(hints[f], leaves) for f in tp._fields])


def retag(a: El, vmax: int, lmax: int | None = None) -> El:
    """Coerce bounds UP (for loop-carrier stability). Asserts validity."""
    lm = lmax if lmax is not None else a.lmax
    assert a.vmax <= vmax and a.lmax <= lm, (a.vmax, vmax, a.lmax, lm)
    return El(a.arr, vmax, lm)


# ---------------------------------------------------------------------------
# Host <-> device conversion
# ---------------------------------------------------------------------------


def from_ints(values, vmax: int | None = None, device="cpu") -> El:
    """Python ints (scalar or nested lists) -> normalised El."""
    arr = np.array(values, dtype=object)
    out = np.zeros((NLIMBS,) + arr.shape, dtype=np.int64)
    flat = arr.reshape(-1)
    oflat = out.reshape(NLIMBS, -1)
    mx = 0
    for j in range(flat.shape[0]):
        v = int(flat[j])
        mx = max(mx, v)
        for i in range(NLIMBS):
            oflat[i, j] = (v >> (LIMB_BITS * i)) & LIMB_MASK
    bound = vmax if vmax is not None else mx + 1
    assert bound <= CAPACITY
    return El(torch.from_numpy(out).to(device), bound, 1 << LIMB_BITS)


def to_ints(a) -> np.ndarray:
    """El or raw (NLIMBS, *batch) limbs -> object ndarray of ints."""
    t = a.arr if isinstance(a, El) else a
    host = np.asarray(t.cpu() if isinstance(t, torch.Tensor) else t)
    host = host.astype(object)
    weights = np.array([1 << (LIMB_BITS * i) for i in range(host.shape[0])],
                       dtype=object)
    return np.tensordot(weights, host, axes=(0, 0))


def to_int(a) -> int:
    """The first value of an El (or raw limbs) as a Python int."""
    return int(to_ints(a).reshape(-1)[0])


@functools.lru_cache(maxsize=None)
def _const_arr(x: int, device: torch.device) -> torch.Tensor:
    # shared by every caller: no function here writes into an input
    return torch.tensor(to_limbs(x, NLIMBS), dtype=DTYPE, device=device)


def const_el(x: int, device="cpu") -> El:
    """Constant -> (NLIMBS,) El with canonical limbs on `device`."""
    return El(_const_arr(x, torch.device(device)), x + 1, 1 << LIMB_BITS)


def _bc(x: torch.Tensor, ndim: int) -> torch.Tensor:
    """Append singleton batch dims so (18, ...) broadcasts against rank ndim."""
    if x.dim() < ndim:
        return x.reshape(tuple(x.shape) + (1,) * (ndim - x.dim()))
    return x


def _bc2(a: torch.Tensor, b: torch.Tensor):
    nd = max(a.dim(), b.dim())
    return _bc(a, nd), _bc(b, nd)


# ---------------------------------------------------------------------------
# Carry chains: loops over the limb axis, one row op per step
# ---------------------------------------------------------------------------


def _pad_cols(cols: torch.Tensor, out_len: int) -> torch.Tensor:
    k = cols.shape[0]
    if out_len > k:
        pad = cols.new_zeros((out_len - k,) + tuple(cols.shape[1:]))
        cols = torch.cat([cols, pad], dim=0)
    return cols[:out_len]


def _carry(cols: torch.Tensor, out_len: int) -> torch.Tensor:
    """Carry propagation over (K, *b) columns -> (out_len, *b) limbs.

    `>>` on int64 is an arithmetic shift, so negative columns (the signed
    chains of sub_mod) propagate negative carries as JAX's int32 chain
    does; the carry out of the top limb is dropped as there."""
    cols = _pad_cols(cols, out_len)
    out = torch.empty(cols.shape, dtype=DTYPE, device=cols.device)
    c = None
    for i in range(out_len):
        v = cols[i] if c is None else cols[i] + c
        torch.bitwise_and(v, MASK, out=out[i])
        c = v >> LIMB_BITS
    return out


def _carry_u(cols: torch.Tensor, out_len: int, col_max: int) -> torch.Tensor:
    """Unsigned carry propagation: (K, *b) columns -> (out_len, *b) limbs."""
    assert col_max < 1 << 31
    return _carry(cols, out_len)


def norm_limbs(a: El) -> El:
    """Carry-normalise limbs to < 2^15 (value unchanged; must fit capacity)."""
    if a.lmax <= (1 << LIMB_BITS):
        return a
    assert a.vmax <= CAPACITY and a.lmax <= _COL_LIMIT
    return El(_carry_u(a.arr, NLIMBS, a.lmax), a.vmax, 1 << LIMB_BITS)


# ---------------------------------------------------------------------------
# Lazy add / offset sub / small-constant mul
# ---------------------------------------------------------------------------


def add_mod(a: El, b: El) -> El:
    """Lazy modular add: one tensor op. Limbs and value bounds sum."""
    aa, ba = _bc2(a.arr, b.arr)
    out = El(aa + ba, a.vmax + b.vmax, a.lmax + b.lmax)
    assert out.lmax <= _COL_LIMIT and out.vmax <= CAPACITY
    return out


def double_mod(a: El) -> El:
    return add_mod(a, a)


def _sub_offset(bound: int, device) -> tuple[int, El]:
    """Smallest multiple of p >= bound (static, exact — overshoot < p)."""
    k = -(-bound // P)
    c = k * P
    return c, const_el(c, device)


def sub_mod(a: El, b: El) -> El:
    """a - b + k p (signed carry chain; output limb-normalised)."""
    c_val, c_el = _sub_offset(b.vmax, a.device)
    assert a.lmax + (1 << LIMB_BITS) + b.lmax < (1 << 31)
    aa, ba = _bc2(a.arr, b.arr)
    out_v = a.vmax + c_val
    assert out_v <= CAPACITY
    ca = _bc(c_el.arr, max(aa.dim(), ba.dim()))
    cols = aa + ca - ba
    return El(_carry(cols, NLIMBS), out_v, 1 << LIMB_BITS)


def neg_mod(a: El) -> El:
    """(k p) - a."""
    c_val, c_el = _sub_offset(a.vmax, a.device)
    ca = _bc(c_el.arr, a.arr.dim())
    cols = ca - a.arr
    return El(_carry(cols, NLIMBS), c_val + 1, 1 << LIMB_BITS)


def mul_small(a: El, k: int) -> El:
    """a * k for a small positive constant (carry-normalised output)."""
    assert 0 < k and a.lmax * k < _COL_LIMIT
    out_v = a.vmax * k
    assert out_v <= CAPACITY
    return El(_carry_u(a.arr * k, NLIMBS, a.lmax * k), out_v, 1 << LIMB_BITS)


# ---------------------------------------------------------------------------
# Montgomery multiplication (radix 2^270)
# ---------------------------------------------------------------------------


def mont_mul(a: El, b: El) -> El:
    """REDC(a*b) with R = 2^270 (CIOS; see kernels/montmul.py).

    Inputs may be limb-lazy (limbs < 2^16 used directly; lazier inputs are
    carry-normalised first) and value-lazy (values < ~2^262). Output:
    limbs < 2^15, value < a.vmax*b.vmax/R + p. No conditional subtraction.
    """
    if a.lmax * b.lmax > _PROD_LIMIT:
        a = norm_limbs(a)
        if a.lmax * b.lmax > _PROD_LIMIT:
            b = norm_limbs(b)
    assert a.lmax * b.lmax <= _PROD_LIMIT
    assert a.vmax * b.vmax + MONT_R * P <= _T_LIMIT

    out_v = a.vmax * b.vmax // MONT_R + P + 1
    assert out_v <= CAPACITY

    aa, bb = _bc2(a.arr, b.arr)
    return El(MK.montmul(aa, bb), out_v, 1 << LIMB_BITS)


def mont_sqr(a: El) -> El:
    return mont_mul(a, a)


# threshold above which tower ops squeeze values back down (see vreduce)
VREDUCE_THRESHOLD = 1 << 261


def vreduce(a: El) -> El:
    """Crush the value bound to ~p without changing the residue: one
    mont_mul by the plain constant (R mod p)."""
    return mont_mul(a, const_el(MONT_R_MOD_P, a.device))


def maybe_vreduce(a: El, threshold: int = VREDUCE_THRESHOLD) -> El:
    return vreduce(a) if a.vmax > threshold else a


# ---------------------------------------------------------------------------
# Canonicalisation, comparison, selection
# ---------------------------------------------------------------------------


def _borrow_chain(arr: torch.Tensor, m: int, diff: torch.Tensor | None):
    """Limb-serial a - m; returns the final borrow (1 where a < m) and
    writes the difference limbs into `diff` when one is given."""
    m_limbs = to_limbs(m, NLIMBS)
    borrow = None
    for i in range(NLIMBS):
        t = arr[i] + ((1 << LIMB_BITS) - m_limbs[i])
        if borrow is not None:
            t = t - borrow
        if diff is not None:
            torch.bitwise_and(t, MASK, out=diff[i])
        borrow = 1 - (t >> LIMB_BITS)
    return borrow


def cond_sub(a: El, m: int) -> El:
    """a - m if a >= m else a (m a static int). Requires normalised limbs."""
    a = norm_limbs(a)
    out_v = min(a.vmax, max(m, a.vmax - m))
    diff = torch.empty(a.arr.shape, dtype=DTYPE, device=a.device)
    borrow = _borrow_chain(a.arr, m, diff)
    keep = (borrow != 0)[None]  # borrow -> a < m -> keep a
    return El(torch.where(keep, a.arr, diff), out_v, 1 << LIMB_BITS)


def canon(a: El) -> El:
    """Full reduction to the canonical representative < p.

    Binary conditional-subtract ladder: ceil(log2(vmax/p)) rounds, each
    halving the bound. Boundary-only cost (codecs, comparisons)."""
    a = norm_limbs(a)
    j = 0
    while (P << j) < a.vmax:
        j += 1
    for jj in range(j - 1, -1, -1):
        a = cond_sub(a, P << jj)
    return El(a.arr, P, a.lmax)


def lt_const(a: El, m: int) -> torch.Tensor:
    """a < m (batch bool)."""
    a = norm_limbs(a)
    return _borrow_chain(a.arr, m, None) != 0


def eq(a: El, b: El) -> torch.Tensor:
    ca, cb = canon(a).arr, canon(b).arr
    ca, cb = _bc2(ca, cb)
    return torch.all(ca == cb, dim=0)


def is_zero(a: El) -> torch.Tensor:
    return torch.all(canon(a).arr == 0, dim=0)


def select(mask: torch.Tensor, t: El, f: El) -> El:
    ta, fa = _bc2(t.arr, f.arr)
    return El(torch.where(mask[None], ta, fa), max(t.vmax, f.vmax),
              max(t.lmax, f.lmax))


# ---------------------------------------------------------------------------
# Montgomery domain conversion, powers
# ---------------------------------------------------------------------------


def to_mont(x: El) -> El:
    """Canonical x -> Montgomery form xR mod p (+ small multiple of p)."""
    return mont_mul(x, const_el(MONT_R2_MOD_P, x.device))


def from_mont(a: El) -> El:
    """Montgomery form -> canonical value < p."""
    return canon(mont_mul(a, const_el(1, a.device)))


def bcast_to(a: El, batch_shape) -> El:
    arr = _bc(a.arr, 1 + len(batch_shape)).expand(
        (NLIMBS,) + tuple(batch_shape))
    return El(arr, a.vmax, a.lmax)


def mont_one(batch_shape=(), device="cpu") -> El:
    return bcast_to(const_el(MONT_R_MOD_P, device), batch_shape)


def mont_zero(batch_shape=(), device="cpu") -> El:
    return bcast_to(const_el(0, device), batch_shape)


def stack(els, axis: int = 1) -> El:
    """Stack elements along a new batch axis (default: first batch dim)."""
    shape = torch.broadcast_shapes(*[e.arr.shape for e in els])
    return El(
        torch.stack([e.arr.expand(shape) for e in els], dim=axis),
        max(e.vmax for e in els),
        max(e.lmax for e in els),
    )


def unstack(a: El, n: int, axis: int = 1):
    return [El(a.arr.select(axis, i), a.vmax, a.lmax) for i in range(n)]


def elmap(fn, a: El, vmax: int | None = None, lmax: int | None = None) -> El:
    """Apply a tensor-level transform (reshape/index/expand) to an El."""
    return El(fn(a.arr), vmax or a.vmax, lmax or a.lmax)


def pow_fixed(a: El, exponent: int) -> El:
    """a^exponent (Montgomery domain), static exponent.

    On CUDA tensors under `config.unroll_static_loops` `_pow_fixed_fused`:
    one fused kernel launch per 3-bit window. Otherwise square-and-multiply
    as a Python loop over the exponent's static bits (the JAX package's
    scan form), leaf by leaf through `mont_mul`. A zero bit keeps the
    square, as the scan's select does, so skipping its multiply gives the
    same limbs."""
    if exponent == 0:
        return mont_one(a.batch_shape, a.device)
    base = retag(norm_limbs(a), STD_BOUND)
    bits = bin(exponent)[2:]
    from .. import config as C
    from . import tower as T

    if C.DEFAULT.unroll_static_loops and T._use_kernels(base):
        return _pow_fixed_fused(base, bits)
    res = base
    for bit in bits[1:]:
        res = mont_sqr(res)
        if bit == "1":
            res = mont_mul(res, base)
        res = retag(res, STD_BOUND)
    return res


# window width of the fused pow chain (the JAX package's `_POW_WINDOW`)
_POW_WINDOW = 3


def _pin_std(e: El) -> El:
    return retag(norm_limbs(e), STD_BOUND, 1 << 16)


def _pow_step_mul(acc: El, m: El) -> El:
    """acc^(2^w) * m — one nonzero window (kernel "el_pow_step_mul")."""
    for _ in range(_POW_WINDOW):
        acc = mont_sqr(acc)
    return _pin_std(mont_mul(acc, m))


def _pow_step_sq(acc: El) -> El:
    """acc^(2^w) — one zero window (kernel "el_pow_step_sq")."""
    for _ in range(_POW_WINDOW):
        acc = mont_sqr(acc)
    return _pin_std(acc)


def _pow_fixed_fused(base: El, bits: str) -> El:
    """Windowed square-and-multiply, the counterpart of the JAX package's
    `_pow_fixed_fused`: MSB-first 3-bit windows of the static exponent
    `bits` (a binary string), the first (possibly short) one seeding the
    accumulator from the table {base^1 .. base^7}; then one
    `el_pow_step_mul` launch per nonzero window, which folds its table
    entry in, and one `el_pow_step_sq` per zero window."""
    from ..kernels import fused as FK

    w = _POW_WINDOW
    lead = len(bits) % w or w
    head = int(bits[:lead], 2)
    rest = [int(bits[i:i + w], 2) for i in range(lead, len(bits), w)]

    table = {1: _pin_std(base)}
    for k in range(2, 1 << w):
        if k % 2 == 0:
            table[k] = _pin_std(mont_sqr(table[k // 2]))
        else:
            table[k] = _pin_std(mont_mul(table[k - 1], table[1]))

    acc = table[head]  # the leading window starts with the exponent's MSB
    for win in rest:
        if win:
            acc = FK.fused_op(_pow_step_mul, "el_pow_step_mul", acc,
                              table[win])
        else:
            acc = FK.fused_op(_pow_step_sq, "el_pow_step_sq", acc)
    return acc


def inv_mod(a: El) -> El:
    """a^{-1} in the Montgomery domain (Fermat)."""
    return pow_fixed(a, P - 2)


def sqrt_candidate(a: El) -> El:
    """a^((p+1)/4) — the square root if a is a QR (p ≡ 3 mod 4)."""
    return pow_fixed(a, (P + 1) // 4)
