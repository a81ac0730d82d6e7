"""G1: E/Fq, y^2 = x^3 + 3 (batched Jacobian over the limb engine).

Counterpart of `bn254_tpu/curve/g1.py`; constructors take the device to
build on.
"""

from __future__ import annotations

import numpy as np

from ..constants import B, G1_GEN
from ..fields import limbs as L
from . import jacobian as J
from .glv import _pin
from .ops import FqOps

OPS = FqOps


def generator(batch_shape=(), device="cpu") -> J.JPoint:
    def bc(v):
        return L.bcast_to(L.to_mont(L.from_ints(v, device=device)),
                          batch_shape)

    return J.JPoint(bc(G1_GEN[0]), bc(G1_GEN[1]),
                    L.mont_one(batch_shape, device))


def identity(batch_shape=(), device="cpu") -> J.JPoint:
    return J.identity(OPS, batch_shape, device)


def add(p1, p2):
    return J.add(OPS, p1, p2)


def _add_body_impl(x1: L.El, y1: L.El, z1: L.El, x2: L.El, y2: L.El,
                   z2: L.El):
    """p1 + p2 (kernel "g1_add", one level of the signature tree-sum): the
    complete addition, its outputs pinned to (STD_BOUND, 2^16) as the GLV
    ladder step's are, so that a tree's levels learn one output template."""
    out = J.add(OPS, J.JPoint(x1, y1, z1), J.JPoint(x2, y2, z2))
    return _pin(out.x), _pin(out.y), _pin(out.z)


def double(p):
    return J.double(OPS, p)


def neg(p):
    return J.neg(OPS, p)


def scalar_mul(p, scalar_limbs, nbits: int = 256):
    return J.scalar_mul(OPS, p, scalar_limbs, nbits)


def to_affine(p):
    return J.to_affine(OPS, p)


def eq(p1, p2):
    return J.eq(OPS, p1, p2)


def is_on_curve_affine(x, y):
    """y^2 == x^3 + 3 for Montgomery-domain affine coords (batch bool)."""
    y2 = L.mont_sqr(y)
    x3 = L.mont_mul(L.mont_sqr(x), x)
    b = L.mul_small(L.mont_one(x.batch_shape, x.device), B)
    return L.eq(y2, L.add_mod(x3, b))


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------


def from_host(points, device="cpu") -> J.JPoint:
    """Host Jacobian int points (a list, or one point) -> batched device
    point. Accepts the host oracle representation (X, Y, Z ints, identity
    Z = 0)."""
    single = not isinstance(points, (list, tuple)) or (
        len(points) == 3 and isinstance(points[0], int)
    )
    if single:
        points = [points]
    dev = J.JPoint(*[
        L.to_mont(L.from_ints([pt[i] for pt in points], device=device))
        for i in range(3)])
    if single:
        dev = L.tree_map(lambda e: L.El(e.arr[:, 0], e.vmax, e.lmax), dev)
    return dev


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
