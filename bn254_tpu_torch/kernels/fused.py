"""Fused bodies: one CUDA kernel launch per tower op, Miller digit or step
op, exp_u window, pow window, GLV ladder step or tree-sum level.

Counterpart of `bn254_tpu/kernels/fused.py:fused_op`. `fused_op(fn, key,
*args)` runs `fn(*args)`, a plain body over El trees (`tower._fq12_mul_impl`,
`miller._dbl_body_impl`, ...), as ONE launch of the hand-written kernel of
`key` in `fused.cu`:

* On CPU tensors it calls the plain body, under `limbs._KERNEL_MODE` so the
  tower ops inside do not dispatch again, and returns its result unchanged
  (limb for limb the JAX package's).
* On CUDA tensors it packs the El leaves, broadcast by the `limbs._bc`
  convention so that an unbatched (18,) constant pairs with (18, *batch),
  into one contiguous (n_in, 18, N) int64 tensor, allocates the
  (n_out, 18, N) output, launches the kernel on the current stream and
  rebuilds the output tree with the static bounds the plain body declares.
  Those are learned once per (body, input bounds) by running the plain body
  on a one-lane CPU input of those bounds (`_out_struct`).
* A key without a kernel, an input beyond the kernels' (2^270, 2^26) input
  bound, a failed build or a failed launch raise. There is no fallback to
  the plain body for CUDA tensors.

The kernels agree with the plain bodies by canonical value; they write
canonical outputs (below p, limbs below 2^15), which lie within any bound a
body declares. Their limbs may differ from the plain body's (see fused.cu).
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import importlib
import inspect
import itertools
import time
import typing

import torch

from .. import obs
from ..constants import NLIMBS, P
from ..fields import limbs as L
from . import build


class Kernel(typing.NamedTuple):
    symbol: str  # the launcher in fused.cu
    body: str  # the plain body, "module:function" in this package
    replaces: str  # the TPU kernel's body, file:line


KERNELS = {
    "miller_dbl_body": Kernel("bn254_miller_dbl_body",
                              "pairing.miller:_dbl_body_impl",
                              "bn254_tpu/pairing/miller.py:257"),
    "miller_add_body": Kernel("bn254_miller_add_body",
                              "pairing.miller:_add_body_impl",
                              "bn254_tpu/pairing/miller.py:265"),
    "miller_dbl_body2": Kernel("bn254_miller_dbl_body2",
                               "pairing.miller:_dbl_body2_impl",
                               "bn254_tpu/pairing/miller.py:334"),
    "miller_add_body2": Kernel("bn254_miller_add_body2",
                               "pairing.miller:_add_body2_impl",
                               "bn254_tpu/pairing/miller.py:352"),
    "expu_step": Kernel("bn254_expu_step", "pairing.final_exp:_expu_step_impl",
                        "bn254_tpu/pairing/final_exp.py:45"),
    "expu_sq2": Kernel("bn254_expu_sq2", "pairing.final_exp:_expu_sq2_impl",
                       "bn254_tpu/pairing/final_exp.py:53"),
    "fq12_mul": Kernel("bn254_fq12_mul", "fields.tower:_fq12_mul_impl",
                       "bn254_tpu/fields/tower.py:374"),
    "fq12_sq": Kernel("bn254_fq12_sq", "fields.tower:_fq12_sq_impl",
                      "bn254_tpu/fields/tower.py:384"),
    "fq12_cyc_sq": Kernel("bn254_fq12_cyc_sq", "fields.tower:_fq12_cyc_sq_impl",
                          "bn254_tpu/fields/tower.py:399"),
    "el_pow_step_mul": Kernel("bn254_el_pow_step_mul",
                              "fields.limbs:_pow_step_mul",
                              "bn254_tpu/fields/limbs.py:783"),
    "el_pow_step_sq": Kernel("bn254_el_pow_step_sq",
                             "fields.limbs:_pow_step_sq",
                             "bn254_tpu/fields/limbs.py:790"),
    "glv_dbl_add": Kernel("bn254_glv_dbl_add", "curve.glv:_dbl_add_body_impl",
                          "bn254_tpu/curve/glv.py:213"),
    "fq12_mul_line": Kernel("bn254_fq12_mul_line",
                            "pairing.miller:_fq12_mul_line_impl",
                            "bn254_tpu/pairing/miller.py:90"),
    "g2_dbl_step": Kernel("bn254_g2_dbl_step", "pairing.miller:_dbl_step_impl",
                          "bn254_tpu/pairing/miller.py:125"),
    "g2_add_step": Kernel("bn254_g2_add_step", "pairing.miller:_add_step_impl",
                          "bn254_tpu/pairing/miller.py:167"),
    # no TPU kernel: the JAX package's tree-sum adds leaf by leaf
    "g1_add": Kernel("bn254_g1_add", "curve.g1:_add_body_impl",
                     "bn254_tpu/dist/batch_verify.py:412"),
}

# the kernels' input contract: values < 2^270, limbs < 2^26 (the limb
# engine's own capacity and carry-chain limits); the load carries them
IN_BOUNDS = (L.CAPACITY, L._COL_LIMIT)

# kernel launches made by `fused_op` in this process, per key; readers reset
launches: dict[str, int] = dict.fromkeys(KERNELS, 0)
# host ns from entry into `fused_op`'s CUDA path to its launch's return,
# summed while an `obs` recorder is installed (no clock is read otherwise)
host_ns = 0
# `_out_struct`'s misses, each a plain-body run on one-lane CPU inputs, and
# their ns; readers take differences
bounds_learned = 0
bounds_learn_ns = 0


@contextlib.contextmanager
def kernel_mode():
    """Run fused bodies as plain code: no tower op inside dispatches."""
    saved = L._KERNEL_MODE
    L._KERNEL_MODE = True
    try:
        yield
    finally:
        L._KERNEL_MODE = saved


@functools.lru_cache(maxsize=None)
def signature(key: str):
    """(plain body, argument types) of `key`, from the body's annotations.
    Imported on first use: the bodies' modules import this one."""
    mod, name = KERNELS[key].body.split(":")
    body = getattr(importlib.import_module(f"..{mod}", __package__), name)
    hints = typing.get_type_hints(body)
    return body, tuple(hints[a] for a in inspect.signature(body).parameters)


def args_from_leaves(key: str, leaves) -> tuple:
    """The body's arguments built from El leaves in flattening order."""
    it = iter(leaves)
    args = tuple(L.tree_from_leaves(t, it) for t in signature(key)[1])
    if next(it, None) is not None:
        raise ValueError(f"more Els than {key} takes")
    return args


def _one_lane(vmax: int, lmax: int) -> L.El:
    return L.El(torch.zeros((NLIMBS, 1), dtype=L.DTYPE), vmax, lmax)


@functools.lru_cache(maxsize=None)
def arity(key: str) -> tuple[int, int]:
    """(input Els, output Els) of the kernel of `key`."""
    lanes = (_one_lane(*IN_BOUNDS) for _ in itertools.count())
    args = tuple(L.tree_from_leaves(t, lanes) for t in signature(key)[1])
    n_in = len(L.tree_leaves(args))
    bounds = ((L.STD_BOUND, 1 << 16),) * n_in
    return n_in, len(L.tree_leaves(_out_struct(signature(key)[0], bounds,
                                               args)))


_out_structs: dict = {}


def _out_struct(fn, bounds_in, args):
    """The output tree of `fn` for inputs of these bounds, as one-lane CPU
    Els with the static bounds the plain body declares (data-independent).
    Raises if a declared bound is below a canonical output's."""
    global bounds_learned, bounds_learn_ns
    key = (fn, bounds_in)
    if key not in _out_structs:
        t0 = time.perf_counter_ns()
        it = iter(bounds_in)
        one = L.tree_map(lambda e: _one_lane(*next(it)), args)
        with kernel_mode():
            out = fn(*one)
        for e in L.tree_leaves(out):
            if e.vmax < P or e.lmax < 1 << 15:
                raise ValueError(f"{fn.__name__} declares an output bound "
                                 "below a canonical value's")
        _out_structs[key] = out
        bounds_learned += 1
        bounds_learn_ns += time.perf_counter_ns() - t0
    return _out_structs[key]


def _on_cuda(els) -> bool:
    """True when the call takes the kernel; mixed devices raise."""
    types = {e.arr.device.type for e in els}
    if types == {"cpu"}:
        return False
    if types != {"cuda"} or len({e.arr.device for e in els}) != 1:
        raise ValueError(f"fused_op needs one device, got {sorted(types)}")
    return True


@functools.lru_cache(maxsize=None)
def _kernel(key: str):
    fn = getattr(build.library("fused"), KERNELS[key].symbol)
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def fused_op(fn, key: str, *args):
    """`fn(*args)` as one kernel launch of `key` (CUDA) or the plain call
    (CPU). Returns fn's tree with (18, *batch) El leaves."""
    global host_ns
    in_els = L.tree_leaves(args)
    if not _on_cuda(in_els):
        with kernel_mode():
            return fn(*args)
    t0 = None if obs.recorder is None else time.perf_counter_ns()
    if key not in KERNELS:
        raise NotImplementedError(f"no CUDA kernel for fused body {key!r}")
    n_in, n_out = arity(key)
    if len(in_els) != n_in:
        raise ValueError(f"{key} takes {n_in} Els, got {len(in_els)}")
    for e in in_els:
        if e.vmax > IN_BOUNDS[0] or e.lmax > IN_BOUNDS[1]:
            raise ValueError(
                f"{key}: input bound (2^{e.vmax.bit_length() - 1}, {e.lmax}) "
                "exceeds the kernel's (2^270, 2^26)")
        if e.arr.dtype != L.DTYPE:
            raise TypeError(f"{key} needs int64 limbs, got {e.arr.dtype}")
    template = _out_struct(fn, tuple((e.vmax, e.lmax) for e in in_els), args)

    packed, batch = pack(in_els)
    n = packed.shape[2]
    out = torch.empty((n_out, NLIMBS, n), dtype=L.DTYPE, device=packed.device)
    if n:
        _launch(key, packed, out)
        launches[key] += 1
    if t0 is not None:
        host_ns += time.perf_counter_ns() - t0
    rows = iter(out)
    return L.tree_map(
        lambda t: L.El(next(rows).reshape((NLIMBS,) + batch), t.vmax, t.lmax),
        template)


def pack(els):
    """Els -> ((len(els), 18, N) contiguous int64, common batch shape).

    Each El broadcasts by the `limbs._bc` convention: singleton batch dims
    are appended, so an unbatched (18,) constant pairs with (18, *batch)."""
    nd = max(e.arr.dim() for e in els)
    full = [L._bc(e.arr, nd) for e in els]
    batch = tuple(torch.broadcast_shapes(*[a.shape[1:] for a in full]))
    n = 1
    for d in batch:
        n *= d
    packed = torch.stack([a.expand((NLIMBS,) + batch) for a in full])
    return packed.reshape(len(els), NLIMBS, n), batch


def _launch(key: str, packed: torch.Tensor, out: torch.Tensor) -> None:
    """The kernel of `key` on the current stream of the tensors' card."""
    kern = _kernel(key)
    dev = packed.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = kern(packed.data_ptr(), out.data_ptr(), packed.shape[2], stream)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch failed: cudaError {rc}")


# the lane-cooperative kernels (fused.cu, "Design"): G threads per lane over
# level schedules (kernels/coop_schedule.py), each with the G it is built
# for (fused.cu's BN254_COOP_GROUPS, BN254_GLV_GROUPS); the launcher picks
# one by the key's rule from the lane count and the card's SM count
_GROUPS = (4, 8, 16, 32, 64)
INSTANCES = {**dict.fromkeys(("miller_dbl_body", "expu_step",
                              "miller_dbl_body2", "miller_add_body2",
                              "fq12_mul", "miller_add_body"), _GROUPS),
             "glv_dbl_add": (1, 2, *_GROUPS),
             **dict.fromkeys(("expu_sq2", "fq12_cyc_sq", "fq12_mul_line",
                              "fq12_sq", "g2_dbl_step", "g2_add_step",
                              "g1_add"), _GROUPS)}
COOP = tuple(INSTANCES)
COOP_INFO = ("blocks_per_sm", "smem_per_block", "lanes_per_block",
             "registers", "stack_bytes", "threads_per_block")


def coop_groups(key: str, lib=None) -> tuple[int, ...]:
    """The group sizes the rule of `key` can pick (fused.cu's kCoopRule,
    kGlvRule, ...), from the CUDA library or a host build `lib`."""
    lib = lib or build.library("fused")
    buf = (ctypes.c_int * 16)()
    n = getattr(lib, f"{KERNELS[key].symbol}_groups")(buf, 16)
    return tuple(buf[:n])


def coop_group(key: str, n: int, sms: int, lib=None) -> int:
    """The group size the launcher of `key` picks for n lanes on `sms`
    SMs."""
    lib = lib or build.library("fused")
    fn = getattr(lib, f"{KERNELS[key].symbol}_group")
    fn.argtypes = [ctypes.c_int64, ctypes.c_int]
    fn.restype = ctypes.c_int
    return fn(n, sms)


def launch_group(key: str, packed: torch.Tensor, out: torch.Tensor,
                 group: int) -> None:
    """The cooperative kernel of `key` with `group` threads per lane (not
    counted in `launches`); raises if that launch fails."""
    fn = getattr(build.library("fused"), f"{KERNELS[key].symbol}_g")
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int64,
                   ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    dev = packed.device
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        rc = fn(packed.data_ptr(), out.data_ptr(), packed.shape[2], group,
                stream)
    if rc != 0:
        raise RuntimeError(f"{key} kernel launch with G={group} failed: "
                           f"cudaError {rc}")


def coop_info(key: str, group: int) -> dict:
    """Occupancy, shared memory and registers of one instantiation."""
    info = (ctypes.c_int * len(COOP_INFO))()
    fn = getattr(build.library("fused"), f"{KERNELS[key].symbol}_info")
    rc = fn(ctypes.c_int(group), info)
    if rc != 0:
        raise RuntimeError(f"{key} G={group}: cudaError {rc}")
    return dict(zip(COOP_INFO, info))
