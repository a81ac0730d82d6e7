"""Host values <-> device tensors (the tensor boundary).

Counterpart of `bn254_tpu/utils/convert.py` — batched conversions between
Python-int points/keys and Montgomery limb tensors — plus the carry-across
functions `from_numpy` & co., which build this package's values from
numpy limb arrays and their static bounds (for instance the JAX package's
`El.arr` and `El.vmax`/`El.lmax`), so the same inputs can be fed to both.
They take numpy only.
"""

from __future__ import annotations

import numpy as np
import torch

from ..constants import MONT_R, NLIMBS, P
from ..errors import ToAffineConversionError
from ..fields import limbs as L
from ..fields import tower as T
from ..host import curve as HC


def _host_to_mont(v: int) -> int:
    """Montgomery conversion on the host (one Python bigint mul)."""
    return (v * MONT_R) % P


def g1_batch_to_device_affine(points_jac, device="cpu"):
    """List of host Jacobian G1 points -> (x, y) Montgomery limb tensors of
    shape (18, B). Identity points raise ToAffineConversionError."""
    affs = [HC.g1_to_affine(p) for p in points_jac]
    if any(a is None for a in affs):
        raise ToAffineConversionError("identity point in G1 batch")
    xs = L.from_ints([_host_to_mont(a[0]) for a in affs], vmax=P, device=device)
    ys = L.from_ints([_host_to_mont(a[1]) for a in affs], vmax=P, device=device)
    return xs, ys


def g2_batch_to_device_affine(points_jac, device="cpu"):
    """List of host Jacobian G2 points -> (Fq2 x, Fq2 y) limb tensors."""
    affs = [HC.g2_to_affine(p) for p in points_jac]
    if any(a is None for a in affs):
        raise ToAffineConversionError("identity point in G2 batch")

    def fq2(vals):
        return T.Fq2(
            L.from_ints([_host_to_mont(v[0]) for v in vals], vmax=P, device=device),
            L.from_ints([_host_to_mont(v[1]) for v in vals], vmax=P, device=device),
        )

    return fq2([a[0] for a in affs]), fq2([a[1] for a in affs])


def scalars_to_device(scalars, device="cpu") -> L.El:
    """List of ints < 2^256 -> (18, B) canonical limb El (no Montgomery).

    vmax is PINNED to 2^256, as in the JAX package (its bound is static
    jit-cache metadata there); ladders read bits, never the bound."""
    vals = list(scalars)
    for v in vals:
        if int(v) >> 256:
            raise ValueError(f"scalar {int(v):#x} exceeds 256 bits")
    return L.from_ints(vals, vmax=1 << 256, device=device)


def g2_const_affine(point_jac, batch_shape=(), device="cpu"):
    """Single host G2 point -> broadcast device affine (Fq2 x, Fq2 y)."""
    aff = HC.g2_to_affine(point_jac)

    def bc(v):
        return L.bcast_to(
            L.from_ints(_host_to_mont(v), vmax=P, device=device), batch_shape)

    return (
        T.Fq2(bc(aff[0][0]), bc(aff[0][1])),
        T.Fq2(bc(aff[1][0]), bc(aff[1][1])),
    )


# ---------------------------------------------------------------------------
# carry-across: numpy limb arrays + static bounds -> this package's values
# ---------------------------------------------------------------------------


def from_numpy(arr, vmax: int, lmax: int, device="cpu") -> L.El:
    """(18, *batch) numpy limbs (any integer dtype) + bounds -> El."""
    a = np.asarray(arr)
    if a.ndim < 1 or a.shape[0] != NLIMBS:
        raise ValueError(f"expected ({NLIMBS}, *batch) limbs, got {a.shape}")
    t = torch.from_numpy(np.ascontiguousarray(a.astype(np.int64)))
    return L.El(t.to(device), int(vmax), int(lmax))


def fq2_from_numpy(parts, device="cpu") -> T.Fq2:
    """Two (arr, vmax, lmax) triples -> Fq2."""
    return T.Fq2(*[from_numpy(*p, device=device) for p in parts])


def fq12_from_numpy(parts, device="cpu") -> T.Fq12:
    """Twelve (arr, vmax, lmax) triples in tower order (c0.c0.c0,
    c0.c0.c1, c0.c1.c0, ..., c1.c2.c1) -> Fq12."""
    els = [from_numpy(*p, device=device) for p in parts]
    assert len(els) == 12
    six = [T.Fq6(*[T.Fq2(els[k + 2 * j], els[k + 2 * j + 1]) for j in range(3)])
           for k in (0, 6)]
    return T.Fq12(*six)


def jpoint_from_numpy(parts, device="cpu"):
    """Three (arr, vmax, lmax) triples (X, Y, Z) -> Jacobian G1 point."""
    from ..curve.jacobian import JPoint

    return JPoint(*[from_numpy(*p, device=device) for p in parts])


def glv_weights_from_numpy(a, b, bits: int, device="cpu"):
    """(18, B) numpy limbs of the GLV halves -> GlvWeights, bounds pinned
    to 2^(bits//2) after checking every value fits."""
    from ..curve.glv import GlvWeights

    half = bits // 2
    ea = from_numpy(a, 1 << half, 1 << 15, device)
    eb = from_numpy(b, 1 << half, 1 << 15, device)
    for e in (ea, eb):
        if any(int(v) >> half for v in np.ravel(L.to_ints(e))):
            raise ValueError(f"GLV weight half exceeds {half} bits")
    return GlvWeights(ea, eb, bits)
