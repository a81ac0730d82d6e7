"""G1: E/Fq, y^2 = x^3 + 3 (batched Jacobian over the limb engine).

Counterpart of `bn254_tpu/curve/g1.py`.
"""

from __future__ import annotations

import numpy as np

from ..fields import limbs as L
from . import jacobian as J
from .ops import FqOps

OPS = FqOps


def add(p1, p2):
    return J.add(OPS, p1, p2)


def scalar_mul(p, scalar_limbs, nbits: int = 256):
    return J.scalar_mul(OPS, p, scalar_limbs, nbits)


def to_affine(p):
    return J.to_affine(OPS, p)


def to_host_affine(x, y, inf):
    """Montgomery affine coords + identity mask -> list of host affine
    tuples (None = identity)."""
    xi = np.ravel(L.to_ints(L.from_mont(x)))
    yi = np.ravel(L.to_ints(L.from_mont(y)))
    infs = np.ravel(inf.cpu().numpy())
    return [
        None if infs[j] else (int(xi[j]), int(yi[j]))
        for j in range(xi.shape[0])
    ]
