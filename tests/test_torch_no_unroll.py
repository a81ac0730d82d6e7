"""The port's `unroll_static_loops=False` configuration vs the JAX package.

With the knob off the card runs the scan forms: the Miller loop one kernel
per step op (`fq12_sq`, `g2_dbl_step`, `g2_add_step`, `fq12_mul_line`),
`exp_u` through the standalone Fq12 ops, the fixed powers and the GLV ladder
leaf by leaf, and the independent tier stacked. Here kernels are forced on
(`tower._on_card`, so `fused_op` runs the plain bodies) with the knob off:

* `miller_loop` on NAF (1, -1), Frobenius steps included, limb for limb
  and bound for bound against JAX's `_miller_loop_scan`, with JAX's
  `fused_op` calling the body and its fused dispatch forced
  (`tower._use_fused`), with the exact dispatch counts;
* `exp_u` on a 2-window prefix holding a zero window against JAX's
  `_exp_u_scan`, the same way;
* the dispatch matrix: each loop and the independent tier pick their scan
  or stacked form with the knob off and their unrolled or pair2 form with it
  on;
* `Config.from_env` honours `BN254_DISABLE_UNROLL`, and `api` refuses a
  passed config with the other loop form.

The scan loop through the host build of the kernels is in
tests/test_torch_fused_host.py; the whole tiers with the knob off in
tests/test_torch_verify.py.
"""

import numpy as np
import pytest

from bn254_tpu.fields import limbs as JL
from bn254_tpu.fields import tower as JT
from bn254_tpu.kernels import fused as JFK
from bn254_tpu.pairing import final_exp as JFE
from bn254_tpu.pairing import miller as JM
from bn254_tpu_torch import config as C
from bn254_tpu_torch.curve import glv as GLV
from bn254_tpu_torch.curve import jacobian as J
from bn254_tpu_torch.dist import batch_verify as BV
from bn254_tpu_torch.fields import limbs as L
from bn254_tpu_torch.fields import tower as T
from bn254_tpu_torch.kernels import fused as FK
from bn254_tpu_torch.pairing import final_exp as FE
from bn254_tpu_torch.pairing import miller as M
from bn254_tpu_torch.utils import convert as CV
from test_torch_fused import (assert_same, easy_part_images, g1_g2_batch,
                              parts, to_jax)


def knob(monkeypatch, on: bool):
    monkeypatch.setattr(C, "DEFAULT",
                        C.DEFAULT.replace(unroll_static_loops=on))


@pytest.fixture()
def scan_on_card(monkeypatch):
    """Knob off and kernels forced on in both packages (JAX's `fused_op`
    calls the body); returns the port's per-key `fused_op` calls."""
    knob(monkeypatch, False)
    monkeypatch.setattr(JFK, "fused_op",
                        lambda fn, key, *args, interpret=False: fn(*args))
    monkeypatch.setattr(JT, "_use_fused", lambda *els: not JL._KERNEL_MODE)
    monkeypatch.setattr(T, "_on_card", lambda els: True)
    calls = dict.fromkeys(FK.KERNELS, 0)
    fused_op = FK.fused_op

    def counted(fn, key, *args):
        calls[key] += 1
        return fused_op(fn, key, *args)

    monkeypatch.setattr(FK, "fused_op", counted)
    return calls


def test_miller_scan_matches_jax(scan_on_card):
    (px, py), (qx, qy) = g1_g2_batch(3)
    naf = (1, -1)  # both add signs; the two Frobenius adds always run
    want = JM._miller_loop_scan(px, py, qx, qy, naf=naf)
    el = lambda e: CV.from_numpy(*parts(e)[0])
    got = M.miller_loop(el(px), el(py), CV.fq2_from_numpy(parts(qx)),
                        CV.fq2_from_numpy(parts(qy)), naf=naf)
    assert_same(want, got)
    assert {k: v for k, v in scan_on_card.items() if v} == {
        "fq12_sq": 2, "g2_dbl_step": 2, "g2_add_step": 4,
        "fq12_mul_line": 6}


def test_exp_u_scan_matches_jax(scan_on_card):
    f = CV.fq12_from_numpy([(np.asarray(e.arr), e.vmax, e.lmax)
                            for e in easy_part_images(20261017, 2)])
    windows = tuple(JFE._U_WINDOWS[:2])
    assert 0 in windows and any(windows)
    want = JFE._exp_u_scan(to_jax(f), window_digits=windows)
    assert_same(want, FE.exp_u(f, windows))
    # the table (one square, one product), then per window two cyclotomic
    # squares and one product, a zero window's by `one`
    assert {k: v for k, v in scan_on_card.items() if v} == {
        "fq12_cyc_sq": 5, "fq12_mul": 3}


def _forms():
    """site -> (call, unrolled form, scan form): each dispatch site with
    the two functions it chooses between, as (module, name)."""
    (px, py), (qx, qy) = g1_g2_batch(7)
    el = lambda e: CV.from_numpy(*parts(e)[0])
    xp, yp = el(px), el(py)
    q = (CV.fq2_from_numpy(parts(qx)), CV.fq2_from_numpy(parts(qy)))
    f = T.fq12_one((2,))
    w = GLV.glv_weights_to_device([(1, 0), (3, 2)], 4)
    p = J.JPoint(xp, yp, L.mont_one((2,)))
    return {
        "miller_loop": (lambda: M.miller_loop(xp, yp, *q),
                        (M, "_miller_loop_unrolled"),
                        (M, "_miller_loop_scan")),
        "exp_u": (lambda: FE.exp_u(f), (FE, "_exp_u_unrolled"),
                  (FE, "_exp_u_scan")),
        # the scan form is inline: its first op is a leaf square
        "pow_fixed": (lambda: L.pow_fixed(xp, 5), (L, "_pow_fixed_fused"),
                      (L, "mont_sqr")),
        "shamir_scalar_mul": (lambda: GLV.shamir_scalar_mul(p, w),
                              (GLV, "_shamir_unrolled"),
                              (GLV, "_shamir_scan")),
        "independent tier": (lambda: BV.verify_batch_independent(
            xp, yp, xp, yp, *q), (BV.DP, "pairing_check2"),
            (BV.DP, "pairing_check")),
    }


SITES = ["miller_loop", "exp_u", "pow_fixed", "shamir_scalar_mul",
         "independent tier"]


@pytest.mark.parametrize("unroll", [True, False])
@pytest.mark.parametrize("site", SITES)
def test_dispatch_follows_the_knob(monkeypatch, site, unroll):
    """Kernels forced on: the unrolled (pair2) form under the knob, the
    scan (stacked) form without it; each form is stubbed to record the
    pick."""
    knob(monkeypatch, unroll)
    monkeypatch.setattr(T, "_on_card", lambda els: True)
    call, fast, slow = _forms()[site]
    picked = []

    class Picked(Exception):
        pass

    for tag, (mod, fn) in (("unrolled", fast), ("scan", slow)):
        def stub(*args, _tag=tag, **kw):
            picked.append(_tag)
            raise Picked

        monkeypatch.setattr(mod, fn, stub)
    with pytest.raises(Picked):
        call()
    assert picked == ["unrolled" if unroll else "scan"]


def test_config_from_env_honours_disable_unroll(monkeypatch):
    monkeypatch.delenv("BN254_DISABLE_UNROLL", raising=False)
    assert C.Config.from_env().unroll_static_loops
    monkeypatch.setenv("BN254_DISABLE_UNROLL", "1")
    assert not C.Config.from_env().unroll_static_loops
    assert C.Config.from_env(unroll_static_loops=True).unroll_static_loops


@pytest.mark.parametrize("default_on", [True, False])
def test_api_refuses_a_passed_config_with_another_loop_form(monkeypatch,
                                                            default_on):
    """The loop form is read from `config.DEFAULT` only, so `api` refuses a
    passed config that asks for the other one, before any work."""
    from bn254_tpu_torch import api

    knob(monkeypatch, default_on)
    other = C.DEFAULT.replace(unroll_static_loops=not default_on)
    with pytest.raises(ValueError, match="unroll_static_loops"):
        api.batch_verify([b"m"], [None], [None], config=other, device="cpu")
    with pytest.raises(ValueError, match="unroll_static_loops"):
        api.batch_sign([b"m"], [1], config=other, device="cpu")
    assert api._config(C.DEFAULT.replace(rlc_bits=64)).rlc_bits == 64
