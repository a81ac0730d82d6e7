"""Process groups and the batch mesh of the sharded verifier.

Counterpart of `bn254_tpu/dist/mesh.py` on `torch.distributed`: one
process per rank, one device per rank, a 1-D batch mesh over the ranks of
the process group. `initialize` starts the process group from a Config
(the environment variables BN254_COORDINATOR, BN254_NUM_PROCESSES and
BN254_PROCESS_ID), `make_mesh` describes it, and `shard_tree` gives a
rank its contiguous slice of a full batch (the SPMD input contract: every
rank passes the same full batch, as in the JAX package).

The backend is NCCL on CUDA devices and gloo on the CPU. NCCL refuses two
ranks on one GPU, so several ranks on one card run gloo
(`initialize(backend="gloo")`); the collectives then stage their payload
through host memory (dist/collectives.py). The JAX package's
`batch_sharding` (a NamedSharding) has no counterpart: `shard_tree`
places each rank's slice itself.
"""

from __future__ import annotations

import dataclasses
import datetime

import torch
import torch.distributed as dist

from ..config import Config
from ..curve.glv import GlvWeights
from ..errors import InvalidLengthError
from ..fields import limbs as L

DEFAULT_TIMEOUT_S = 300.0

# the device the last `initialize` chose for this process: `make_mesh`'s
# default (the process group it starts is process-wide state as well)
_device: torch.device | None = None


@dataclasses.dataclass(frozen=True)
class Mesh:
    """A 1-D batch mesh: the ranks of a process group, one device each.

    group: the process group (None: a world of one, no process group).
    size, rank: the group's size and this process's rank in it.
    axis_name: the axis the sharded verifier reduces over.
    device: this rank's device, where its shard and its Fq12 live.
    """

    group: object | None
    size: int
    rank: int
    axis_name: str
    device: torch.device

    @property
    def backend(self) -> str | None:
        """The group's backend name ("nccl", "gloo"), None without one."""
        return None if self.group is None else str(dist.get_backend(self.group))


def _rank_device(rank: int, device=None) -> torch.device:
    """`device`, or the card `cuda:(rank % device_count)`, which must
    exist: the CPU is used only when asked for."""
    if device is None and torch.cuda.is_available():
        return torch.device("cuda", rank % torch.cuda.device_count())
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def initialize(cfg: Config | None = None, *, device=None,
               backend: str | None = None,
               timeout: float = DEFAULT_TIMEOUT_S, **overrides) -> bool:
    """Start the process group from a Config (or kwargs).

    Returns True if a multi-process group was started, False for the
    single-process no-op (no coordinator, or one process). The device is
    `device`, else the card `cuda:(process_id % device_count)`; without
    CUDA and no `device="cpu"` this raises, in either case. The backend
    is `backend`, else NCCL for a CUDA device and gloo for the CPU; gloo
    with a CUDA device is how several ranks share one card. Every
    collective of the group gives up after `timeout` seconds, so a rank
    that dies does not leave the others blocked.
    """
    global _device
    cfg = (cfg or Config.from_env()).replace(**overrides)
    dev = _rank_device(cfg.process_id, device)
    _device = dev
    if not cfg.coordinator_address or cfg.num_processes <= 1:
        return False
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError(f"the NCCL backend needs a CUDA device, not {dev}")
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(
        backend,
        init_method=f"tcp://{cfg.coordinator_address}",
        world_size=cfg.num_processes,
        rank=cfg.process_id,
        timeout=datetime.timedelta(seconds=timeout),
    )
    return True


def make_mesh(n_devices: int | None = None, axis_name: str = "batch", *,
              device=None) -> Mesh:
    """1-D batch mesh over every rank of the process group, or a world of
    one in a process without one (as `jax.devices()` is one CPU device).

    n_devices: must be the group's size (or None): a rank is a device.
    device: this rank's device; default the one `initialize` chose, else
    the card `cuda:(rank % device_count)`.
    """
    if dist.is_initialized():
        group, size, rank = dist.group.WORLD, dist.get_world_size(), \
            dist.get_rank()
    else:
        group, size, rank = None, 1, 0
    n = size if n_devices is None else n_devices
    if n != size:
        raise InvalidLengthError(
            f"the mesh spans the group's {size} ranks, asked for {n}"
        )
    dev = _rank_device(rank, device if device is not None else _device)
    return Mesh(group, size, rank, axis_name, dev)


def _batch_size(tree) -> int:
    if isinstance(tree, GlvWeights):
        tree = tree.a
    return L.tree_leaves(tree)[0].batch_shape[-1]


def shard_tree(tree, mesh: Mesh):
    """This rank's contiguous slice [r·B/n, (r+1)·B/n) of a full-batch El /
    Fq2 / GlvWeights tree (or a tuple of them), on the mesh's device.

    Every rank must pass the SAME full-batch values (the SPMD input
    contract of the JAX package's `shard_tree`). A batch that the mesh
    size does not divide raises InvalidLengthError.
    """
    from .batch_verify import _slice_batch

    if type(tree) in (tuple, list):
        return type(tree)(shard_tree(t, mesh) for t in tree)
    B = _batch_size(tree)
    if B % mesh.size != 0:
        raise InvalidLengthError(
            f"batch {B} must divide the mesh axis size {mesh.size}"
        )
    n = B // mesh.size
    piece = _slice_batch(tree, slice(mesh.rank * n, (mesh.rank + 1) * n))
    if isinstance(piece, GlvWeights):
        return piece.to(mesh.device)
    return L.tree_map(
        lambda e: L.El(e.arr.to(mesh.device), e.vmax, e.lmax), piece)


def is_multiprocess() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def process_info() -> tuple[int, int]:
    """(process_id, process_count)."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()
