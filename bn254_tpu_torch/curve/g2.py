"""Device G2: E'/Fq2, y^2 = x^3 + 3/xi (batched Jacobian over the tower).

Counterpart of `bn254_tpu/curve/g2.py`; constructors take the device to
build on. On CUDA tensors its products run the montmul kernel, as G1's do:
the JAX module reaches no Pallas kernel but the leaf. bench.py's config 5
derives its public keys with `scalar_mul` of the generator on the device.
"""

from __future__ import annotations

import numpy as np

from ..constants import G2_GEN_X, G2_GEN_Y
from ..fields import limbs as L
from ..fields import tower as T
from ..host import curve as HC
from . import jacobian as J
from .ops import Fq2Ops

OPS = Fq2Ops

# b' = 3/xi as host ints (computed by the oracle; constant of the twist)
B2_HOST = HC.B2


def _bc_fq2(val, batch_shape, device):
    def bc(v):
        return L.bcast_to(L.to_mont(L.from_ints(v, device=device)),
                          batch_shape)

    return T.Fq2(bc(val[0]), bc(val[1]))


def generator(batch_shape=(), device="cpu") -> J.JPoint:
    return J.JPoint(
        _bc_fq2(G2_GEN_X, batch_shape, device),
        _bc_fq2(G2_GEN_Y, batch_shape, device),
        T.fq2_one(batch_shape, device),
    )


def identity(batch_shape=(), device="cpu") -> J.JPoint:
    return J.identity(OPS, batch_shape, device)


def add(p1, p2):
    return J.add(OPS, p1, p2)


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


def is_on_curve_affine(x: T.Fq2, y: T.Fq2):
    """y^2 == x^3 + b' for Montgomery-domain affine coords (batch bool).
    The JAX module passes `x.c0` to `Fq2Ops.batch_shape`, which reads
    `.c0` of it again and raises; this takes the batch shape of `x`."""
    y2 = T.fq2_sq(y)
    x3 = T.fq2_mul(T.fq2_sq(x), x)
    b2 = _bc_fq2(B2_HOST, OPS.batch_shape(x), OPS.device(x))
    return T.fq2_eq(y2, T.fq2_add(x3, b2))


# ---------------------------------------------------------------------------
# host <-> device
# ---------------------------------------------------------------------------


def from_host(points, device="cpu") -> J.JPoint:
    """Host Jacobian Fq2 points (a list, or one point) -> batched device
    point."""
    single = not isinstance(points, list)
    if single:
        points = [points]

    def fq2_batch(vals):
        return T.Fq2(
            L.to_mont(L.from_ints([v[0] for v in vals], device=device)),
            L.to_mont(L.from_ints([v[1] for v in vals], device=device)),
        )

    dev = J.JPoint(
        fq2_batch([pt[0] for pt in points]),
        fq2_batch([pt[1] for pt in points]),
        fq2_batch([pt[2] for pt in points]),
    )
    if single:
        dev = L.tree_map(lambda e: L.El(e.arr[:, 0], e.vmax, e.lmax), dev)
    return dev


def to_host_affine(p: J.JPoint):
    """Batched device point -> host affine ((x0, x1), (y0, y1)) list, None
    for the identity (one point for an unbatched one)."""
    x, y, inf = to_affine(p)
    fx0, fx1, fy0, fy1 = (np.ravel(L.to_ints(L.from_mont(c)))
                          for c in (x.c0, x.c1, y.c0, y.c1))
    infs = inf.cpu().numpy()
    fi = np.ravel(infs)
    out = [
        None
        if fi[j]
        else ((int(fx0[j]), int(fx1[j])), (int(fy0[j]), int(fy1[j])))
        for j in range(fx0.shape[0])
    ]
    if infs.ndim == 0:
        return out[0]
    return out
