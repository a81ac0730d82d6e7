"""High-level batched device API: sign / verify / aggregate / key consistency.

Counterpart of `bn254_tpu/api.py` (`batch_sign`, `batch_verify`,
`aggregate_signatures`, `aggregate_public_keys`, `batch_check_public_keys`).
Bridges protocol objects (`protocol/types.py`: host points as Python ints)
and the device pipeline (Montgomery limb tensors). The device entry points
run on the CUDA card unless the caller passes `device="cpu"`; with no card
and no `device=` they raise. The two aggregations run on the host.
"""

from __future__ import annotations

import numpy as np
import torch

from . import obs
from .curve import g1 as DG1
from .curve import jacobian as J
from .dist import batch_verify as BV
from .fields import limbs as L
from .fields import tower as T
from .hash.tai_batch import hash_to_g1_device
from .host import curve as HC
from .pairing import pairing as DP
from .protocol.types import PublicKey, Signature
from .utils import convert as CV


def resolve_device(device=None) -> torch.device:
    """`device` as a torch.device; None means the CUDA card, which must
    exist (the CPU is used only when asked for)."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run on the CPU"
        )
    return dev


def _scalar(k) -> int:
    return int(getattr(k, "scalar", k))


def _config(config):
    """`config`, or `config.DEFAULT` when None. The loop form is read from
    `config.DEFAULT` at each dispatch site, as in the JAX package, so a
    passed config may not ask for another one."""
    from . import config as CFG

    cfg = config or CFG.DEFAULT
    if cfg.unroll_static_loops != CFG.DEFAULT.unroll_static_loops:
        raise ValueError(
            "unroll_static_loops is read from config.DEFAULT (environment "
            "BN254_DISABLE_UNROLL), not from a passed config")
    return cfg


@torch.inference_mode()
def batch_sign(messages: list[bytes], private_keys, config=None,
               device=None) -> list[Signature]:
    """Sign a batch of messages on the device: [sk_i] H(m_i).

    private_keys: PrivateKeys, or ints. Device pipeline: batched SHA-256
    try-and-increment hash, a batched 256-step scalar ladder and one
    batched affine conversion. Bit-exact with `ECDSA.sign` per message.
    """
    cfg = _config(config)
    if len(messages) != len(private_keys):
        raise ValueError("one private key per message")
    dev = resolve_device(device)
    hx, hy = hash_to_g1_device(messages, cfg.k_candidates, dev)
    sk = CV.scalars_to_device([_scalar(k) for k in private_keys], dev)
    h = J.JPoint(hx, hy, L.mont_one(hx.batch_shape, dev))
    sx, sy, inf = DG1.to_affine(DG1.scalar_mul(h, sk))
    return [
        Signature(HC.G1_IDENTITY if aff is None else HC.g1_from_affine(aff))
        for aff in DG1.to_host_affine(sx, sy, inf)
    ]


@torch.inference_mode()
def batch_verify(messages: list[bytes], signatures, public_keys,
                 mode: str = "independent", config=None, device=None,
                 weights=None):
    """Verify a batch of (message, signature, public key) tuples.

    signatures / public_keys: Signatures and PublicKeys (any object with a
    `.point` host Jacobian point, G1 and G2). mode="independent": per-tuple
    bools (np.ndarray), each tuple checked on its own. mode="fused": ONE
    combined check with random linear-combination weights and a single
    shared final exponentiation (returns a bool: all valid); a forged tuple
    passes with probability ~2^-rlc_bits. mode="adaptive": per-tuple bools
    at the fused cost when every tuple is valid, with the independent tier
    as the fallback.
    weights: explicit RLC weights (GlvWeights, PlainWeights or ints);
    None draws fresh cryptographic ones per `config.glv_weights`.
    """
    cfg = _config(config)
    n = len(messages)
    if len(signatures) != n or len(public_keys) != n:
        raise ValueError("one signature and one public key per message")
    if mode not in ("independent", "fused", "adaptive"):
        raise ValueError(f"unknown mode {mode!r}")
    dev = resolve_device(device)
    with obs.span("verify"):
        hx, hy = hash_to_g1_device(messages, cfg.k_candidates, dev)
        with obs.span("convert"):
            sx, sy = CV.g1_batch_to_device_affine(
                [s.point for s in signatures], dev)
            pqx, pqy = CV.g2_batch_to_device_affine(
                [k.point for k in public_keys], dev)
        if mode == "independent":
            return BV.verify_batch_independent(
                hx, hy, sx, sy, pqx, pqy).cpu().numpy()
        if weights is None:
            with obs.span("weights"):
                if cfg.glv_weights:
                    weights = BV.random_weights(n, cfg.rlc_bits, dev)
                else:
                    weights = BV.random_weights_plain(n, cfg.rlc_bits)
        if mode == "adaptive":
            return np.asarray(BV.verify_batch_adaptive(
                hx, hy, sx, sy, pqx, pqy, weights=weights, nbits=cfg.rlc_bits
            ).cpu())
        return bool(BV.verify_batch_fused(hx, hy, sx, sy, pqx, pqy, weights,
                                          nbits=cfg.rlc_bits))


def aggregate_signatures(signatures) -> Signature:
    """Aggregate signatures: their sum in G1 (host arithmetic)."""
    acc = HC.G1_IDENTITY
    for s in signatures:
        acc = HC.g1_add(acc, s.point)
    return Signature(acc)


def aggregate_public_keys(public_keys) -> PublicKey:
    """Aggregate public keys: their sum in G2 (host arithmetic)."""
    acc = HC.G2_IDENTITY
    for k in public_keys:
        acc = HC.g2_add(acc, k.point)
    return PublicKey(acc)


@torch.inference_mode()
def batch_check_public_keys(public_keys_g2, public_keys_g1,
                            device=None) -> np.ndarray:
    """Batched G2 <-> G1 key-consistency check: per pair,
    e(G1::one, PK2_i) * e(-PK1_i, G2::one) == 1.

    public_keys_g2 / public_keys_g1: PublicKeys and PublicKeyG1s (objects
    with a `.point` host Jacobian point, G2 and G1). Returns np.ndarray of
    bool, one per pair. On the card (`batch_verify._use_pair2`) the
    shared-squaring two-pair Miller loop with +G2::one's precomputed lines;
    otherwise the two pairs stacked.
    """
    n = len(public_keys_g2)
    if len(public_keys_g1) != n:
        raise ValueError("one G1 public key per G2 public key")
    dev = resolve_device(device)
    g1x, g1y = CV.g1_batch_to_device_affine(
        [HC.g1_neg(k.point) for k in public_keys_g1], dev)
    pqx, pqy = CV.g2_batch_to_device_affine(
        [k.point for k in public_keys_g2], dev)
    onex, oney = (L.bcast_to(c, (n,))
                  for c in CV.g1_batch_to_device_affine([HC.G1_ONE], dev))

    if BV._use_pair2(onex, g1x, pqx):
        # pair 1, the G1-side key against +G2::one, folds the generator's
        # precomputed lines
        ok = DP.pairing_check2(onex, oney, pqx, pqy, g1x, g1y,
                               q_const="g2_one")
    else:
        g2x, g2y = CV.g2_const_affine(HC.G2_ONE, (n,), dev)
        ok = DP.pairing_check(L.stack([onex, g1x]), L.stack([oney, g1y]),
                              T.fq2_stack([pqx, g2x]), T.fq2_stack([pqy, g2y]))
    return ok.cpu().numpy()
