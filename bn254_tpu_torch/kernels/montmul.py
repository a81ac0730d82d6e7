"""Batched CIOS Montgomery multiplication: the CUDA kernel and its plain
torch version.

`montmul(a, b)` is the leaf multiply of the whole package
(fields/limbs.py:mont_mul). On CUDA tensors it always launches the
hand-written kernel in `montmul.cu` (the port of the Pallas TPU kernel
`bn254_tpu/kernels/montmul.py:_montmul_kernel`); a failed build or launch
raises. On CPU tensors it runs `montmul_plain`, the int64 torch mirror of
`bn254_tpu/fields/limbs.py:_mont_mul_scan`, which the CPU tests hold
against the JAX package and `chip_smoke.py` holds the kernel against.

Both compute REDC(a*b) with R = 2^270 over 18 limbs of 15 bits, with lazy
column accumulation, one final carry chain and no conditional subtract,
for limbs < 2^16 and a.vmax*b.vmax + R*p < 2^538 (the caller's contract).
"""

from __future__ import annotations

import ctypes
import functools

import torch

from ..constants import LIMB_BITS, LIMB_MASK, NLIMBS, P, to_limbs
from . import build

PINV0 = (-pow(P, -1, 1 << LIMB_BITS)) % (1 << LIMB_BITS)
_P_LIMBS = tuple(to_limbs(P, NLIMBS))

# kernel launches made by `montmul_cuda` in this process; readers reset it
launches = 0


def montmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """REDC(a*b) for broadcast-compatible (18, *batch) int64 limb tensors.

    CPU tensors take the plain version; CUDA tensors the kernel."""
    if a.device.type == "cpu" and b.device.type == "cpu":
        return montmul_plain(a, b)
    return montmul_cuda(a, b)


@functools.lru_cache(maxsize=None)
def _p_limbs(device: torch.device) -> torch.Tensor:
    return torch.tensor(_P_LIMBS, dtype=torch.int64, device=device)


def montmul_plain(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain torch CIOS, the int64 mirror of the JAX scan form.

    The accumulator keeps every absolute column (2*18 rows), so step i
    works on columns i.. and the per-step one-limb shift is an offset.
    The a*b columns are summed up front: column i holds all its a*b terms
    by step i in the scan too, and integer addition in int64 is exact in
    any order, so m_i, every column and the output limbs are the scan's.
    """
    a, b = torch.broadcast_tensors(a, b)
    batch = tuple(a.shape[1:])
    p = _p_limbs(a.device).reshape((NLIMBS,) + (1,) * len(batch))

    # a*b columns: lo(a_i b_j) -> column i+j, hi(a_i b_j) -> column i+j+1,
    # skew-summed: row i of q, flattened and re-viewed with rows one
    # shorter, lands entry (i, j) at column i + j
    prod = a[:, None] * b[None]  # (18, 18, *batch), < 2^32
    width = 2 * NLIMBS + 2
    q = a.new_zeros((NLIMBS, width) + batch)
    q[:, :NLIMBS] = prod & LIMB_MASK
    q[:, 1:NLIMBS + 1] += prod >> LIMB_BITS
    skew = q.reshape((NLIMBS * width,) + batch)[: NLIMBS * (width - 1)]
    t = skew.reshape((NLIMBS, width - 1) + batch).sum(dim=0)

    for i in range(NLIMBS):
        m_i = (t[i] * PINV0) & LIMB_MASK
        prod2 = m_i[None] * p
        t[i:i + NLIMBS] += prod2 & LIMB_MASK
        t[i + 1:i + NLIMBS + 1] += prod2 >> LIMB_BITS
        t[i + 1] += t[i] >> LIMB_BITS  # t[i] & MASK == 0 by construction

    out = torch.empty((NLIMBS,) + batch, dtype=torch.int64, device=a.device)
    c = None
    for i in range(NLIMBS):
        v = t[NLIMBS + i] if c is None else t[NLIMBS + i] + c
        torch.bitwise_and(v, LIMB_MASK, out=out[i])
        c = v >> LIMB_BITS
    return out


@functools.lru_cache(maxsize=None)
def _kernel():
    lib = build.library("montmul")
    fn = lib.bn254_montmul
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                   ctypes.c_int64, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def montmul_cuda(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Launch the CUDA kernel on the current stream (no synchronise)."""
    global launches
    if a.device.type != "cuda" or a.device != b.device:
        raise ValueError(
            f"montmul_cuda needs both operands on one CUDA device, got "
            f"{a.device} and {b.device}"
        )
    if a.dtype != torch.int64 or b.dtype != torch.int64:
        raise TypeError(f"montmul_cuda needs int64 limbs, got {a.dtype}, {b.dtype}")
    a, b = torch.broadcast_tensors(a, b)
    shape = a.shape
    if len(shape) == 0 or shape[0] != NLIMBS:
        raise ValueError(f"montmul_cuda needs ({NLIMBS}, *batch) limbs, got {tuple(shape)}")
    n = a.numel() // NLIMBS
    a2 = a.reshape(NLIMBS, n).contiguous()
    b2 = b.reshape(NLIMBS, n).contiguous()
    out = torch.empty((NLIMBS, n), dtype=torch.int64, device=a.device)
    if n:
        fn = _kernel()
        with torch.cuda.device(a.device):
            stream = torch.cuda.current_stream(a.device).cuda_stream
            rc = fn(a2.data_ptr(), b2.data_ptr(), out.data_ptr(), n, stream)
        if rc != 0:
            raise RuntimeError(f"montmul kernel launch failed: cudaError {rc}")
        launches += 1
    return out.reshape(shape)
