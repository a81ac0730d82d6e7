"""The port's CIOS montmul (plain torch version) vs the JAX package.

`bn254_tpu_torch.kernels.montmul.montmul_plain` is what a CPU tensor runs
and what `chip_smoke.py` holds the CUDA kernel against on the card. Here
it is held limb for limb against the JAX scan path (`limbs.mont_mul` on
the CPU backend) and the Pallas kernel body in interpret mode, and by
value against the Python-int Montgomery oracle, on random inputs, the
lazy boundary inputs of tests/test_kernel_montmul.py (limbs 2^16 - 1,
values near the 2^538 contract) and a broadcast operand.
"""

import jax
import numpy as np
import pytest
import torch

from bn254_tpu.constants import MONT_R, NLIMBS, P
from bn254_tpu.fields import limbs as JL
from bn254_tpu.kernels import montmul as JMK
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.kernels import montmul as MK
from bn254_tpu_torch.utils import convert as CV

RINV = pow(MONT_R, -1, P)


def carry(el):
    return CV.from_numpy(np.asarray(el.arr), el.vmax, el.lmax)


def np64(x):
    return np.asarray(x.arr if hasattr(x, "arr") else x).astype(np.int64)


def rand_el(rng, n, bound=P):
    return JL.from_ints(
        [int.from_bytes(rng.bytes(32), "little") % bound for _ in range(n)],
        vmax=bound)


def lazy_boundary_el(rng, n, top):
    """Limbs at the 2^16-1 lazy maximum, top limb `top`, jittered."""
    arr = np.full((NLIMBS, n), (1 << 16) - 1, dtype=np.uint32)
    arr[NLIMBS - 1, :] = top
    for j in range(n):
        arr[rng.integers(NLIMBS - 1), j] = rng.integers(1 << 16)
    vmax = int(max(JL.to_ints(arr).reshape(-1))) + 1
    return JL.El(jax.numpy.asarray(arr), vmax, 1 << 16)


def check_value(a_el, b_el, got):
    a_vals = JL.to_ints(np64(a_el)).reshape(-1)
    b_vals = JL.to_ints(np64(b_el)).reshape(-1)
    out = JL.to_ints(got.numpy()).reshape(-1)
    for a, b, g in zip(np.broadcast_to(a_vals, out.shape),
                       np.broadcast_to(b_vals, out.shape), out):
        assert int(g) % P == (int(a) * int(b) * RINV) % P
        assert int(g) < 1 << 270


@pytest.mark.parametrize("n, seed", [(1, 11), (7, 12), (300, 13)])
def test_plain_matches_jax_scan_random(n, seed):
    rng = np.random.default_rng(seed)
    a, b = rand_el(rng, n), rand_el(rng, n)
    want = JL.mont_mul(a, b)
    got = L.mont_mul(carry(a), carry(b))
    assert np.array_equal(np64(want), got.arr.numpy())
    assert (got.vmax, got.lmax) == (want.vmax, want.lmax)
    check_value(a, b, got.arr)


def test_plain_matches_jax_scan_lazy_boundary():
    rng = np.random.default_rng(107)
    a = lazy_boundary_el(rng, 64, 0x7F)
    b = lazy_boundary_el(rng, 64, 0x7F)
    assert a.vmax * b.vmax + MONT_R * P < 1 << 538
    assert a.vmax * b.vmax + MONT_R * P > 1 << 520  # near the contract
    want = JL.mont_mul(a, b)
    got = MK.montmul_plain(carry(a).arr, carry(b).arr)
    assert np.array_equal(np64(want), got.numpy())
    check_value(a, b, got)


def test_plain_matches_jax_scan_edge_values():
    ints = [0, 1, P - 1, P, MONT_R % P] + [2**k for k in range(0, 255, 16)]
    a = JL.from_ints(ints)
    b = JL.from_ints(list(reversed(ints)))
    want = JL.mont_mul(a, b)
    got = L.mont_mul(carry(a), carry(b))
    assert np.array_equal(np64(want), got.arr.numpy())


def test_plain_broadcast_operand():
    """(18,) x (18, B): the scalar operand fans out per lane."""
    rng = np.random.default_rng(109)
    a = rand_el(rng, 1)
    a0 = JL.El(a.arr[:, 0], a.vmax, a.lmax)  # (18,)
    b = rand_el(rng, 33)
    want = JL.mont_mul(a0, b)
    got = L.mont_mul(carry(a0), carry(b))
    assert got.arr.shape == (NLIMBS, 33)
    assert np.array_equal(np64(want), got.arr.numpy())
    got2 = MK.montmul_plain(carry(a0).arr[:, None], carry(b).arr)
    assert np.array_equal(np64(want), got2.numpy())


def test_plain_matches_pallas_interpret():
    """The Pallas kernel body itself (interpret mode) on a small batch."""
    rng = np.random.default_rng(113)
    a = lazy_boundary_el(rng, 8, 0x3F)
    b = rand_el(rng, 8)
    want = JMK.montmul_batched(a.arr, b.arr, interpret=True)
    got = MK.montmul_plain(carry(a).arr, carry(b).arr)
    assert np.array_equal(np64(want), got.numpy())


def test_cpu_tensors_take_the_plain_version():
    rng = np.random.default_rng(5)
    a, b = carry(rand_el(rng, 4)), carry(rand_el(rng, 4))
    before = MK.launches
    out = MK.montmul(a.arr, b.arr)
    assert MK.launches == before
    assert torch.equal(out, MK.montmul_plain(a.arr, b.arr))


def test_kernel_wrapper_refuses_cpu_tensors():
    z = torch.zeros((NLIMBS, 4), dtype=torch.int64)
    with pytest.raises(ValueError):
        MK.montmul_cuda(z, z)
