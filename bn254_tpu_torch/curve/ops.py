"""Field-op bundles exposing Fq (limbs) and Fq2 (tower) through one interface.

Lets the branch-free Jacobian arithmetic in `jacobian.py` be written once
for G1 (coords in Fq) and G2 (coords in Fq2). Counterpart of
`bn254_tpu/curve/ops.py`; constructors take the device to build on.
"""

from __future__ import annotations

from ..fields import limbs as L
from ..fields import tower as T


class FqOps:
    """Fq: elements are (18, *batch) int64 Montgomery limb tensors."""

    add = staticmethod(L.add_mod)
    sub = staticmethod(L.sub_mod)
    mul = staticmethod(L.mont_mul)
    sq = staticmethod(L.mont_sqr)
    neg = staticmethod(L.neg_mod)
    mul_small = staticmethod(L.mul_small)
    inv = staticmethod(L.inv_mod)
    is_zero = staticmethod(L.is_zero)
    eq = staticmethod(L.eq)
    select = staticmethod(L.select)
    zero = staticmethod(L.mont_zero)
    one = staticmethod(L.mont_one)
    double = staticmethod(L.double_mod)

    @staticmethod
    def batch_shape(a):
        return a.batch_shape

    @staticmethod
    def device(a):
        return a.device

    @staticmethod
    def retag(a, vmax):
        e = L.norm_limbs(a) if a.lmax > (1 << 16) else a
        return L.retag(e, vmax, 1 << 16)


class Fq2Ops:
    """Fq2: elements are tower.Fq2 named tuples of Montgomery limb tensors."""

    add = staticmethod(T.fq2_add)
    sub = staticmethod(T.fq2_sub)
    mul = staticmethod(T.fq2_mul)
    sq = staticmethod(T.fq2_sq)
    neg = staticmethod(T.fq2_neg)
    double = staticmethod(T.fq2_double)
    mul_small = staticmethod(T.fq2_mul_small)
    inv = staticmethod(T.fq2_inv)
    is_zero = staticmethod(T.fq2_is_zero)
    eq = staticmethod(T.fq2_eq)
    select = staticmethod(T.fq2_select)
    zero = staticmethod(T.fq2_zero)
    one = staticmethod(T.fq2_one)
    retag = staticmethod(T.fq2_retag)

    @staticmethod
    def batch_shape(a):
        return a.c0.batch_shape

    @staticmethod
    def device(a):
        return a.c0.device
