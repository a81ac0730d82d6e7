"""Cross-rank collectives for BN254 batch verification.

Counterpart of `bn254_tpu/dist/collectives.py`. The key reduction is an
all-reduce whose monoid is Fq12 multiplication, which no backend offers
as a reduce op. The JAX package builds it from `ppermute` rounds
(recursive doubling); here each rank packs its value into one contiguous
int64 tensor (12 x 18 limbs for an Fq12, 3 x 18 for a Jacobian G1 point),
ONE `all_gather` hands every rank all n values, and every rank multiplies
them itself in rank order: n - 1 products on every rank (one-lane kernel
launches on the card), for any n, and bit-identical limbs on every rank.

The gathered values take the static bounds (vmax, lmax) of the local
one: every rank runs the same code on a shard of the same width, so its
value's bounds are the same on every rank. `fq12_allreduce_mul` pins them
to the standard bound (`fq12_retag`) before the gather as well.

With gloo and a CUDA device (several ranks on one card: NCCL refuses two
ranks on one GPU) the payload goes through host memory.
"""

from __future__ import annotations

import functools

import torch
import torch.distributed as dist

from ..curve import g1 as DG1
from ..errors import InvalidLengthError
from ..fields import limbs as L
from ..fields import tower as T


def pack(x) -> torch.Tensor:
    """The limbs of an El tree (an Fq12, a JPoint...) as one contiguous
    1-D int64 tensor, leaf after leaf, depth first."""
    return torch.stack([e.arr for e in L.tree_leaves(x)]).reshape(-1)


def unpack(buf: torch.Tensor, like):
    """The El tree of `pack`'s layout in `buf`, shaped and bounded like
    `like`."""
    leaves = L.tree_leaves(like)
    rows = iter(buf.reshape((len(leaves),) + tuple(leaves[0].arr.shape)))
    return L.tree_map(lambda e: L.El(next(rows), e.vmax, e.lmax), like)


def all_gather(buf: torch.Tensor, mesh) -> torch.Tensor:
    """(mesh.size, buf.numel()): every rank's `buf`, row r from rank r, on
    buf's device. One collective; through host memory when the backend is
    gloo and `buf` lies on the card."""
    staged = mesh.backend == "gloo" and buf.is_cuda
    src = buf.cpu() if staged else buf
    out = torch.empty((mesh.size, src.numel()), dtype=src.dtype,
                      device=src.device)
    dist.all_gather(list(out.unbind(0)), src, group=mesh.group)
    return out.to(buf.device) if staged else out


def allreduce_monoid(x, mul_fn, mesh):
    """All-reduce the El tree `x` over the mesh under the associative
    `mul_fn`, for ANY mesh size: one gather, then the n values multiplied
    in rank order on every rank. A mesh of one returns `x`."""
    if mesh.size < 1:
        raise InvalidLengthError(f"axis size must be >= 1, got {mesh.size}")
    if mesh.size == 1:
        return x
    gathered = all_gather(pack(x), mesh)
    return functools.reduce(mul_fn, (unpack(row, x) for row in gathered))


def jacobian_allreduce_add(p, mesh):
    """All-reduce a (per-rank) Jacobian G1 point by the complete group
    addition (`curve/g1.add`)."""
    return allreduce_monoid(p, DG1.add, mesh)


def fq12_allreduce_mul(f: T.Fq12, mesh) -> T.Fq12:
    """Product of f over the mesh, the same limbs on every rank."""
    return T.fq12_retag(allreduce_monoid(T.fq12_retag(f), T.fq12_mul, mesh))
