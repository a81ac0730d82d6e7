"""The port's pair2 independent tier vs the JAX package.

pair2 is the shared-squaring two-pair Miller loop with a constant second
G2 point whose lines are precomputed on the host
(`pairing/precompute.py`, `miller._miller_loop_pair2_unrolled`): the JAX
package's default independent tier, which the port runs on the card.
Inputs are host points or numpy limbs fed to both packages; limbs are
compared with `np.array_equal` together with the (vmax, lmax) bounds
unless a test says "by value":

* the coefficient schedules of -G2::one and +G2::one on the full schedule;
* the loop on a truncated schedule (both add signs, both Frobenius steps)
  for both constants, the JAX side with its `fused_op` calling the body
  eagerly (no jit, no XLA compile);
* the dispatch with kernels forced on (`tower._on_card`, plain bodies):
  `verify_batch_independent` gives the bools tests/test_torch_independent.py
  holds against JAX, with 65 + 23 pair2 launches on the full schedule, and
  its Miller value equals the stacked form's by value;
* `api.batch_check_public_keys` on both forms.

The loop through the host build of the kernels, on a truncated schedule,
is in tests/test_torch_fused_host.py.
"""

import pytest
import torch

from bn254_tpu.kernels import fused as JFK
from bn254_tpu.pairing import miller as JM
from bn254_tpu.pairing import precompute as JPC
from bn254_tpu.utils import convert as JCV
from bn254_tpu_torch import api
from bn254_tpu_torch.dist import batch_verify as BV
from bn254_tpu_torch.fields import tower as T
from bn254_tpu_torch.hash.tai import hash_to_g1
from bn254_tpu_torch.host import curve as HC
from bn254_tpu_torch.kernels import fused as FK
from bn254_tpu_torch.pairing import miller as M
from bn254_tpu_torch.pairing import pairing as DP
from bn254_tpu_torch.pairing import precompute as PC
from bn254_tpu_torch.utils import convert as CV
from test_torch_fused import assert_same, canon_values, parts
from test_torch_independent import EXPECTED

CONSTS = {"neg_g2_one": HC.g2_neg(HC.G2_ONE), "g2_one": HC.G2_ONE}


def tuple_points(n=2):
    """(P0 list, P1 list, Q0 list) host points of a two-pair tuple batch."""
    return ([HC.g1_mul(HC.G1_ONE, 3 + i) for i in range(n)],
            [HC.g1_mul(HC.G1_ONE, 100 + i) for i in range(n)],
            [HC.g2_mul(HC.G2_ONE, 7 + 4 * i) for i in range(n)])


@pytest.mark.parametrize("q_const", sorted(CONSTS))
def test_coeff_schedule_matches_jax(q_const):
    got = getattr(PC, f"{q_const}_coeffs")()
    assert got == getattr(JPC, f"{q_const}_coeffs")()
    kinds = [k for k, *_ in got]
    assert kinds.count("dbl") == 65 and kinds.count("add") == 23


@pytest.mark.parametrize("q_const", sorted(CONSTS))
def test_pair2_loop_matches_jax(monkeypatch, q_const):
    monkeypatch.setattr(JFK, "fused_op",
                        lambda fn, key, *args, interpret=False: fn(*args))
    naf = (1, -1)  # both add signs; the two Frobenius adds always run
    p0, p1, q0 = tuple_points()
    jargs = (*JCV.g1_batch_to_device_affine(p0),
             *JCV.g2_batch_to_device_affine(q0),
             *JCV.g1_batch_to_device_affine(p1))
    aff = HC.g2_to_affine(CONSTS[q_const])
    want = JM._miller_loop_pair2_unrolled(
        *jargs, JPC.g2_line_coeffs(aff, naf=naf), naf=naf)
    el = lambda e: CV.from_numpy(*parts(e)[0])
    hx, hy, (qx0, qx1), (qy0, qy1), sx, sy = (
        el(jargs[0]), el(jargs[1]), parts(jargs[2]), parts(jargs[3]),
        el(jargs[4]), el(jargs[5]))
    got = M._miller_loop_pair2_unrolled(
        hx, hy, CV.fq2_from_numpy([qx0, qx1]), CV.fq2_from_numpy([qy0, qy1]),
        sx, sy, PC.g2_line_coeffs(aff, naf=naf), naf=naf)
    assert_same(want, got)


@pytest.fixture()
def on_card(monkeypatch):
    """Kernels forced on: the card's composition with the plain bodies;
    returns the per-key `fused_op` calls."""
    calls = dict.fromkeys(FK.KERNELS, 0)
    fused_op = FK.fused_op

    def counted(fn, key, *args):
        calls[key] += 1
        return fused_op(fn, key, *args)

    monkeypatch.setattr(T, "_on_card", lambda els: True)
    monkeypatch.setattr(FK, "fused_op", counted)
    return calls


def miller_counts(calls):
    keys = ("miller_dbl_body2", "miller_add_body2", "miller_dbl_body",
            "miller_add_body", "expu_step", "expu_sq2")
    counts = tuple(calls[k] for k in keys)
    calls.update(dict.fromkeys(calls, 0))
    return counts


def test_independent_tier_dispatches_on_pair2_miller(on_card, monkeypatch):
    """tests/test_torch_independent.py's tampered B=4 batch gives EXPECTED
    through pair2 (65 + 23 two-pair launches on the full schedule, no
    single-pair body); its Miller value equals, by value, the stacked form's
    (the two pairs through the single-pair bodies, then the pair-axis
    product), which the CPU takes."""
    msgs = [b"tv-%d" % i for i in range(4)]
    sks = [1000 + 7 * i for i in range(4)]
    hpts = [hash_to_g1(m) for m in msgs]
    sigs = [HC.g1_mul(h, k) for h, k in zip(hpts, sks)]
    sigs[2] = HC.g1_mul(sigs[2], 3)
    batch = (*CV.g1_batch_to_device_affine(hpts),
             *CV.g1_batch_to_device_affine(sigs),
             *CV.g2_batch_to_device_affine(
                 [HC.g2_mul(HC.G2_ONE, k) for k in sks]))
    miller2, seen = DP._miller2, []
    monkeypatch.setattr(DP, "_miller2",
                        lambda *a, **kw: seen.append(miller2(*a, **kw))
                        or seen[-1])
    assert BV._use_pair2(batch[0], batch[2], batch[4])
    assert BV.verify_batch_independent(*batch).tolist() == EXPECTED
    assert miller_counts(on_card) == (65, 23, 0, 0, 69, 24)

    stacked = DP.fq12_reduce_mul(
        M.miller_loop(*BV._independent_pairs(*batch)))
    assert miller_counts(on_card) == (0, 0, 65, 23, 0, 0)
    assert canon_values(seen[0]) == canon_values(stacked)


class Key:
    def __init__(self, point):
        self.point = point


def key_pairs():
    """(G2 keys, G1 keys): a consistent pair, then PK1 != sk G1."""
    sks = [77, 1234]
    return ([Key(HC.g2_mul(HC.G2_ONE, k)) for k in sks],
            [Key(HC.g1_mul(HC.G1_ONE, k + i)) for i, k in enumerate(sks)])


def test_batch_check_public_keys(monkeypatch):
    """The stacked form (CPU); with no card and no `device=` it raises."""
    pk2, pk1 = key_pairs()
    got = api.batch_check_public_keys(pk2, pk1, device="cpu")
    assert got.tolist() == [True, False]

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        api.batch_check_public_keys(pk2, pk1)
    with pytest.raises(ValueError):
        api.batch_check_public_keys(pk2, pk1[:1], device="cpu")


def test_batch_check_public_keys_on_pair2(on_card):
    """pair2 with +G2::one's precomputed lines (kernels forced on)."""
    got = api.batch_check_public_keys(*key_pairs(), device="cpu")
    assert got.tolist() == [True, False]
    assert miller_counts(on_card) == (65, 23, 0, 0, 69, 24)
