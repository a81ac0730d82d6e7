"""Random lazy limbs within given bounds, for checking fused kernels
against their plain bodies (`chip_smoke.py`, `tests/test_torch_fused*.py`).

An El's bounds are (vmax, lmax): value below vmax, every limb below lmax.
The kernels must agree with the plain bodies anywhere inside those bounds,
so the samples reach their edges.
"""

from __future__ import annotations

import numpy as np

from ..constants import LIMB_BITS, LIMB_MASK, NLIMBS


def bounded_limbs(rng: np.random.Generator, vmax: int, lmax: int,
                  n: int) -> np.ndarray:
    """(18, n) int64 limbs of random values below vmax with every limb
    below lmax: canonical limbs of a value below 2^(bits of vmax - 1), then
    a random carry moved back down into each limb, lowest first. With
    n >= 3 the first three lanes are the edges: vmax - 1 with every low
    limb as large as lmax allows, vmax - 1 canonical, and zero."""
    top = vmax.bit_length() - 1
    x = rng.integers(0, 1 << LIMB_BITS, size=(NLIMBS, n), dtype=np.int64)
    for j in range(NLIMBS):
        x[j] &= (1 << min(LIMB_BITS, max(0, top - LIMB_BITS * j))) - 1
    if n >= 3:
        x[:, :2] = [[((vmax - 1) >> (LIMB_BITS * j)) & LIMB_MASK]
                    for j in range(NLIMBS)]
        x[:, 2] = 0
    for j in range(NLIMBS - 1):
        most = np.minimum(x[j + 1], (lmax - 1 - x[j]) >> LIMB_BITS)
        k = (rng.random(n) * (most + 1)).astype(np.int64)
        if n >= 3:
            k[:2] = most[0], 0
        x[j + 1] -= k
        x[j] += k << LIMB_BITS
    return x
