"""Batched and sharded BLS verification (the throughput workload).

Counterpart of `bn254_tpu/dist/batch_verify.py`:

1. `verify_batch_independent` — N independent (H(m), sig, pk) tuples:
   each tuple is its own 2-pair product check with its own final
   exponentiation. On the card (`_use_pair2`) the shared-squaring two-pair
   Miller loop with -G2::one's precomputed lines; on the CPU, and on the
   card with `config.unroll_static_loops` off, the pair axis stacked in
   front of the batch axis.
2. `verify_batch_fused` — N tuples fused into ONE pairing-product check
   with random linear-combination weights:
   prod_i e([w_i]H_i, pk_i) * e(-sum_i [w_i]sig_i, G2) == 1, a single
   shared final exponentiation; `verify_batch_fused_chunked` streams a
   batch too large for one pass through it in chunks (BASELINE config 5).
3. `verify_batch_adaptive` — tier 2 first; only a rejected batch pays for
   tier 1, which then says which tuples failed.
4. `make_sharded_verifier` — tier 2 sharded over the ranks of a
   `torch.distributed` process group (dist/mesh.py): shard-local points,
   Miller loops and Fq12 product, ONE Fq12-product all-reduce
   (dist/collectives.py), one final exponentiation on every rank.

RLC weights are cryptographic (`secrets`, curve/glv.py); every entry point
also accepts explicit weights.
"""

from __future__ import annotations

import dataclasses
import secrets

import torch

from .. import obs
from ..curve import g1 as DG1
from ..curve import glv as GLV
from ..curve import jacobian as J
from ..errors import InvalidLengthError
from ..fields import limbs as L
from ..fields import tower as T
from ..host import curve as HC
from ..kernels import fused as FK
from ..pairing import final_exp as FE
from ..pairing import miller as M
from ..pairing import pairing as DP
from ..utils import convert as CV
from . import collectives as COLL
from . import mesh as MESH


def _neg_g2_one(batch_shape, device):
    return CV.g2_const_affine(HC.g2_neg(HC.G2_ONE), batch_shape, device)


# ---------------------------------------------------------------------------
# Tier 1: independent batch verification
# ---------------------------------------------------------------------------


def _independent_pairs(hx, hy, sx, sy, pqx, pqy):
    B = hx.batch_shape[-1]
    # pair axis in front of the batch axis: (18, 2, B)
    px = L.stack([hx, sx])
    py = L.stack([hy, sy])
    ngx, ngy = _neg_g2_one((B,), hx.device)
    qx = T.fq2_stack([pqx, ngx])
    qy = T.fq2_stack([pqy, ngy])
    return px, py, qx, qy


@torch.inference_mode()
def verify_batch_independent(hx, hy, sx, sy, pqx, pqy) -> torch.Tensor:
    """N independent verifies -> bool (B,).

    hx/hy: hash points H(m_i) (18, B); sx/sy: signatures (18, B);
    pqx/pqy: public keys (tower.Fq2 with (18, B) components).
    Each tuple checks e(H, pk) * e(sig, -G2::one) == 1 with its own final
    exponentiation (exact per-tuple accept/reject).
    """
    with obs.span("independent"):
        if _use_pair2(hx, sx, pqx):
            return DP.pairing_check2(hx, hy, pqx, pqy, sx, sy)
        return DP.pairing_check(*_independent_pairs(hx, hy, sx, sy, pqx,
                                                    pqy))


def _use_pair2(hx, sx, pqx) -> bool:
    """The shared-squaring constant-Q two-pair Miller loop
    (`pairing.pairing_check2`): on the kernels (CUDA tensors) under
    `config.unroll_static_loops`, as the JAX package takes it on its fused
    path by default."""
    from .. import config as C

    return C.DEFAULT.unroll_static_loops and T._use_kernels(hx, sx, pqx.c0)


# ---------------------------------------------------------------------------
# Tier 2: fused batch verification (random linear combination)
# ---------------------------------------------------------------------------


def random_weights(n: int, bits: int | None = None, device="cpu"):
    """Cryptographic RLC weights in GLV form (first fixed to 1)."""
    if bits is None:
        from .. import config as C

        bits = C.DEFAULT.rlc_bits
    return GLV.random_glv_weights(n, bits, device)


def random_weights_plain(n: int, bits: int | None = None):
    """Plain int weights, uniform over [1, 2^bits) (first fixed to 1).
    Zero is redrawn: an unweighted tuple would drop out of the check."""
    if bits is None:
        from .. import config as C

        bits = C.DEFAULT.rlc_bits

    def draw():
        while True:
            w = secrets.randbits(bits)
            if w:
                return w

    return [1] + [draw() for _ in range(n - 1)]


@dataclasses.dataclass(frozen=True)
class PlainWeights:
    """Device-resident plain RLC weights, validated at conversion time
    (`weights_to_device`); `bits` is the ladder length they fit."""

    w: L.El
    bits: int


def weights_to_device(weights, bits: int | None = None,
                      device="cpu") -> PlainWeights:
    """Validate host int weights against `bits` (default config.rlc_bits)
    and convert ONCE to a device tensor reusable across many calls."""
    if bits is None:
        from .. import config as C

        bits = min(int(C.DEFAULT.rlc_bits), 256)
    return PlainWeights(
        CV.scalars_to_device(_check_weights(weights, bits), device), bits
    )


def _check_weights(weights, bits: int):
    """Host-side guard: every RLC weight must fit the ladder length."""
    for w in weights:
        if int(w) >> bits:
            raise ValueError(
                f"RLC weight {int(w):#x} exceeds {bits} bits "
                "(config.rlc_bits); the weight ladder would truncate it"
            )
    return weights


def _resolve_weights(weights, nbits: int | None, device):
    """Normalise a weights argument to (device weights, ladder bits).

    weights: GlvWeights (carries its own validated width), PlainWeights
    (validated at conversion), or a host sequence of ints, validated HERE
    against the ladder length. Raw El tensors are rejected: their bound
    cannot be checked on the host, and an oversize weight would silently
    truncate in the ladder and weaken the 2^-rlc_bits forgery bound.
    """
    if isinstance(weights, GLV.GlvWeights):
        return weights.to(device), weights.half_bits
    if isinstance(weights, PlainWeights):
        return L.El(weights.w.arr.to(device), weights.w.vmax,
                    weights.w.lmax), weights.bits
    if isinstance(weights, L.El):
        raise TypeError(
            "raw El weight tensors are not accepted (their < 2^rlc_bits "
            "bound cannot be validated host-side); pass a GlvWeights or "
            "a host list of ints"
        )
    if nbits is None:
        from .. import config as C

        nbits = min(int(C.DEFAULT.rlc_bits), 256)
    return CV.scalars_to_device(_check_weights(weights, nbits), device), nbits


def _apply_weights(hx, hy, sx, sy, w, nbits: int):
    """([w_i]H_i, [w_i]sig_i) for both weight forms: GLV weights run ONE
    Shamir ladder over the (H, sig) pair axis, plain weights the generic
    nbits-step ladder."""
    p = J.JPoint(
        L.stack([hx, sx]),
        L.stack([hy, sy]),
        L.mont_one((2,) + tuple(hx.batch_shape), hx.device),
    )
    if isinstance(w, GLV.GlvWeights):
        wp = GLV.shamir_scalar_mul(p, w)
    else:
        wp = DG1.scalar_mul(p, w, nbits)
    xs = L.unstack(wp.x, 2)
    ys = L.unstack(wp.y, 2)
    zs = L.unstack(wp.z, 2)
    return J.JPoint(xs[0], ys[0], zs[0]), J.JPoint(xs[1], ys[1], zs[1])


def _el_append(a: L.El, b: L.El) -> L.El:
    """Concat a scalar-batch El onto the trailing batch axis of `a`."""
    bb = b.arr.reshape(tuple(b.arr.shape) + (1,) * (a.arr.dim() - b.arr.dim()))
    bb = bb.expand(tuple(a.arr.shape[:-1]) + (1,))
    return L.El(
        torch.cat([a.arr, bb], dim=-1),
        max(a.vmax, b.vmax),
        max(a.lmax, b.lmax),
    )


def _g1_tree_sum(p: J.JPoint, axis: int = 0) -> J.JPoint:
    """Tree-sum a batched Jacobian G1 point along a batch axis (an odd
    leftover row rides along to the next round). On CUDA tensors each
    level's pair add is one "g1_add" kernel launch; on the CPU the complete
    add leaf by leaf, as in the JAX package."""
    taxis = axis + 1
    on_card = T._use_kernels(p.x, p.y, p.z)

    def take(start, stop):
        return lambda e: L.El(e.arr.narrow(taxis, start, stop - start),
                              e.vmax, e.lmax)

    n = p.x.arr.shape[taxis]
    while n > 1:
        half = n // 2
        p1 = L.tree_map(take(0, half), p)
        p2 = L.tree_map(take(half, 2 * half), p)
        if on_card:
            s = J.JPoint(*FK.fused_op(DG1._add_body_impl, "g1_add", *p1, *p2))
        else:
            s = DG1.add(p1, p2)
        if n % 2:
            rest = L.tree_map(take(2 * half, n), p)
            s = DP._cat_els(s, rest, taxis)
            n = half + 1
        else:
            n = half
        p = s
    return L.tree_map(lambda e: L.El(e.arr.squeeze(taxis), e.vmax, e.lmax), p)


def _fused_points(hx, hy, sx, sy, pqx, pqy, w, nbits: int):
    """Stage A of the fused check: weight ladders, signature tree-sum, and
    the (B+1)-row point batch — the B weighted hash points plus the
    signature-sum row S = sum_i [w_i]sig_i with -G2::one as its partner.
    Everything affinizes in ONE batched pass."""
    with obs.span("points"):
        with obs.span("points.ladder"):
            wh, ws = _apply_weights(hx, hy, sx, sy, w, nbits)
        with obs.span("points.tree_sum"):
            s_sum = _g1_tree_sum(ws)

        p_all = J.JPoint(
            _el_append(wh.x, s_sum.x),
            _el_append(wh.y, s_sum.y),
            _el_append(wh.z, s_sum.z),
        )
        with obs.span("points.to_affine"):
            px, py, inf = DG1.to_affine(p_all)

        ngx, ngy = _neg_g2_one((1,), hx.device)
        qx = T.Fq2(_el_append(pqx.c0, ngx.c0), _el_append(pqx.c1, ngx.c1))
        qy = T.Fq2(_el_append(pqy.c0, ngy.c0), _el_append(pqy.c1, ngy.c1))
        return px, py, qx, qy, inf


def _miller_reduce(px, py, qx, qy, inf):
    """Stage B: batched Miller loop + Fq12 product -> scalar Fq12. The inf
    mask makes an identity row contribute 1 (e(O, Q) == 1)."""
    with obs.span("miller"):
        f = M.miller_loop(px, py, qx, qy, inf_mask=inf)
        return T.fq12_retag(DP.fq12_reduce_mul(f, axis=0))


def _fused_local_product(hx, hy, sx, sy, pqx, pqy, w, nbits: int):
    """Stages A+B: a SCALAR (batch-()) Fq12. Combine shards or chunks by
    fq12_mul, then ONE final_exp + is_one."""
    return _miller_reduce(*_fused_points(hx, hy, sx, sy, pqx, pqy, w, nbits))


@torch.inference_mode()
def verify_batch_fused(hx, hy, sx, sy, pqx, pqy, weights,
                       nbits: int | None = None) -> torch.Tensor:
    """Fused check: prod_i e([w_i]H_i, pk_i) * e(S, -G2) == 1 where
    S = sum_i [w_i]sig_i. Returns a 0-dim bool tensor on the device.

    weights: GlvWeights / PlainWeights / list of ints (`_resolve_weights`).
    One shared final exponentiation for the whole batch.
    """
    with obs.span("fused"):
        w, nb = _resolve_weights(weights, nbits, hx.device)
        f_red = _fused_local_product(hx, hy, sx, sy, pqx, pqy, w, nb)
        return _is_one(FE.final_exp(f_red))


def _is_one(f):
    """The fused checks' last step, `fq12_is_one` of the final
    exponentiation's output, in the span `is_one`."""
    with obs.span("is_one"):
        return T.fq12_is_one(f)


def _slice_batch(x, sl: slice):
    """Slice the trailing batch dim of an El / Fq2 / GlvWeights tree (a
    view: no copy)."""
    if isinstance(x, GLV.GlvWeights):
        return GLV.GlvWeights(_slice_batch(x.a, sl), _slice_batch(x.b, sl),
                              x.bits)
    return L.tree_map(lambda e: L.El(e.arr[..., sl], e.vmax, e.lmax), x)


def _chunk_combine(f_acc, f_c):
    """Fold one chunk's Miller product into the accumulator: one
    `fq12_mul` (one kernel launch at one lane on the card)."""
    return T.fq12_retag(T.fq12_mul(f_acc, f_c))


@torch.inference_mode()
def verify_batch_fused_chunked(hx, hy, sx, sy, pqx, pqy, weights,
                               chunk: int,
                               nbits: int | None = None) -> torch.Tensor:
    """`verify_batch_fused` for batches too large for one pass (BASELINE
    config 5: 1,048,576 tuples on one chip in chunks of 8,192).

    The fused check's reduction is a monoid (the Fq12 Miller product; each
    chunk's signature-sum row rides inside its own Miller batch, see
    `_fused_points`), so the batch streams through in `chunk`-sized
    pieces into one Fq12 accumulator, then ONE shared final
    exponentiation: the unchunked check's accept/reject semantics. Each
    chunk's intermediates die with its iteration, so device memory beyond
    the inputs is O(chunk). A batch that is no multiple of `chunk` raises
    InvalidLengthError.
    """
    w, nb = _resolve_weights(weights, nbits, hx.device)
    B = hx.batch_shape[-1]
    if chunk <= 0 or B % chunk != 0:
        raise InvalidLengthError(
            f"batch {B} must be a multiple of chunk {chunk}")

    with obs.span("fused"):
        f_acc = None
        for off in range(0, B, chunk):
            sl = slice(off, off + chunk)
            f_c = _fused_local_product(
                *(_slice_batch(x, sl) for x in (hx, hy, sx, sy, pqx, pqy, w)),
                nb)
            f_acc = f_c if f_acc is None else _chunk_combine(f_acc, f_c)
        return _is_one(FE.final_exp(f_acc))


class AdaptiveResult:
    """Deferred result of `verify_batch_adaptive(defer=True)`, made without
    a host synchronisation: the pre-check bit is copied to pinned host
    memory on the device's stream and a CUDA event marks its arrival, so
    a caller can enqueue the next batch before reading this one.

    per_tuple: device (B,) bool — the pre-check bit broadcast batch-wide.
      For a batch that passes the pre-check this IS the final answer.
    resolve(): waits for the bit; on rejection runs the exact independent
      fallback and returns its per-tuple bools instead.
    """

    def __init__(self, per_tuple, ok_host, event, fallback):
        self.per_tuple = per_tuple
        self._ok_host = ok_host
        self._event = event
        self._fallback = fallback
        self._resolved = None

    def resolve(self) -> torch.Tensor:
        if self._resolved is None:
            if self._event is not None:
                with obs.span("resolve.wait"):
                    self._event.synchronize()
            if bool(self._ok_host):
                self._resolved = self.per_tuple
            else:
                self._resolved = self._fallback()
        return self._resolved

    def __array__(self, dtype=None, copy=None):
        a = self.resolve().cpu().numpy()
        return a if dtype is None else a.astype(dtype)


@torch.inference_mode()
def verify_batch_adaptive(hx, hy, sx, sy, pqx, pqy,
                          weights=None, nbits: int | None = None,
                          defer: bool = False):
    """Per-tuple results at fused-tier cost for the common all-valid case:
    run the fused RLC check first (ONE shared final exp); if it accepts,
    every tuple is valid (up to the 2^-rlc_bits RLC soundness bound). On
    rejection, fall back to the exact independent tier to report WHICH
    tuples failed.

    weights=None draws fresh cryptographic ones per config.glv_weights.
    defer=False: returns a (B,) bool tensor. defer=True: returns an
    `AdaptiveResult` at once; call .resolve() (or np.asarray) for the bools.
    """
    B = hx.batch_shape[-1]
    if weights is None:
        from .. import config as C

        with obs.span("weights"):
            if C.DEFAULT.glv_weights:
                weights = random_weights(B, nbits, hx.device)
            else:
                weights = random_weights_plain(B, nbits)
    ok = verify_batch_fused(hx, hy, sx, sy, pqx, pqy, weights, nbits=nbits)
    per_tuple = ok.reshape(1).expand(B)
    if ok.is_cuda:
        ok_host = torch.empty((), dtype=torch.bool, pin_memory=True)
        ok_host.copy_(ok, non_blocking=True)
        event = torch.cuda.Event()
        event.record()
    else:
        ok_host, event = ok, None
    res = AdaptiveResult(
        per_tuple, ok_host, event,
        lambda: verify_batch_independent(hx, hy, sx, sy, pqx, pqy),
    )
    return res if defer else res.resolve()


# ---------------------------------------------------------------------------
# Tier 4: sharded fused verification over a process group
# ---------------------------------------------------------------------------


def make_sharded_verifier(mesh: MESH.Mesh, axis_name: str = "batch",
                          nbits: int | None = None):
    """Build an SPMD fused verifier over `mesh` (dist/mesh.py).

    Every rank calls the returned `run` with the SAME full batch. It runs
    the JAX package's staged pipeline, one stage after another:
      1. per chunk, on the rank's shard of it (`mesh.shard_tree`): the
         weight ladders, the shard's signature-sum row, the Miller loops
         and the Fq12 product (`_fused_local_product`; bilinearity makes
         the shards' S rows compose by product, no G1 collective);
      2. the chunks folded into a per-rank accumulator (`_chunk_combine`),
         no communication;
      3. the Fq12-product all-reduce (`collectives.fq12_allreduce_mul`),
         the ONLY collective, once per job;
      4. ONE final exponentiation and is_one, on every rank.
    It returns the same 0-dim bool on every rank, on the mesh's device.

    Weights are required, as in the JAX package: a GlvWeights (its own
    width), a PlainWeights, or a list of ints validated against `nbits`
    (default config.rlc_bits at build time); every rank passes the same
    full-batch weights and takes its slice. The JAX package's
    `monolithic=True` (one XLA program) and its TPU-only `final_exp_wide`
    have no counterpart.
    """
    if axis_name != mesh.axis_name:
        raise ValueError(
            f"the mesh's axis is {mesh.axis_name!r}, not {axis_name!r}")
    if nbits is None:
        from .. import config as C

        nbits = min(int(C.DEFAULT.rlc_bits), 256)
    n_dev = mesh.size

    @torch.inference_mode()
    def run(hx, hy, sx, sy, pqx, pqy, weights,
            chunk: int | None = None) -> torch.Tensor:
        """hx..sy: El (18, B); pqx/pqy: Fq2 of El; weights: see above.

        chunk: stream the batch in `chunk`-sized pieces, each split over
        the ranks: peak memory O(chunk) instead of O(B), and still ONE
        collective and ONE final exponentiation per job. None runs the
        one-shot form. The batch must divide by the mesh size, and by
        `chunk`, which must divide by the mesh size (InvalidLengthError).
        """
        B = hx.batch_shape[-1]
        if B % n_dev != 0:
            raise InvalidLengthError(
                f"batch {B} must divide the mesh axis size {n_dev}")
        w, nb = _resolve_weights(weights, nbits, hx.device)
        if chunk is None:
            chunk = B
        elif chunk <= 0 or B % chunk != 0 or chunk % n_dev != 0:
            raise InvalidLengthError(
                f"batch {B} must be a multiple of chunk {chunk}, "
                f"which must divide the mesh axis size {n_dev}")
        f_acc = None
        for off in range(0, B, chunk):
            piece = tuple(_slice_batch(x, slice(off, off + chunk))
                          for x in (hx, hy, sx, sy, pqx, pqy, w))
            f_local = _fused_local_product(*MESH.shard_tree(piece, mesh), nb)
            f_acc = (f_local if f_acc is None
                     else _chunk_combine(f_acc, f_local))
        f_all = COLL.fq12_allreduce_mul(f_acc, mesh)  # once per job
        return _is_one(FE.final_exp(f_all))

    return run
