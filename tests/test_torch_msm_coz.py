"""The port's co-Z MSM engine (``multiexp(method="coz")``) against the referees.

Against the bigint oracle (``tpu_ec.curves.oracle.msm``) at small n and the
native C++ Pippenger at 2^10, with the edge cases of tests/test_msm_coz.py:
identity bases and zero scalars (the digit-0 slot, identity encoding), all
scalars equal (one maximal run per window, the adversarial case for the
halving rounds), cancelling pairs (P and -P under one scalar), windows 2
and 8, and the chunked path.  tpu_ec's own co-Z engine is not called
here: its CPU compile takes minutes.  Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_BLS, BN254_G1 as J_BN
from tpu_ec_torch.curves import BLS12_381_G1, BN254_G1
from tpu_ec_torch.ops.msm import MultiexpKernel
from tpu_ec_torch.ops.msm_coz import default_window_size_coz
from tpu_ec_torch.ops.msm_sorted import _plan_sizes


def _coz(tspec, pts, ks, **kw):
    kern = MultiexpKernel(tspec, "cpu", chunk_size=kw.pop("chunk_size", None))
    ops = kern.ops
    out = kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), method="coz", **kw)
    return ops.to_affine_ints(ops.to_affine(out))[0]


@pytest.mark.parametrize("n", [1, 33])
def test_random_vs_oracle(n):
    pts = oracle.random_points(J_BN, n, seed=90 + n)
    ks = oracle.random_scalars(J_BN, n, seed=91 + n)
    assert _coz(BN254_G1, pts, ks) == oracle.msm(J_BN, pts, ks)


def test_2_10_vs_native_pippenger():
    from tpu_ec.native import native_curve

    n = 1 << 10
    nc = native_curve(J_BLS)
    rng = np.random.default_rng(92)
    k = np.zeros((n, 4), dtype=np.uint64)
    k[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    G = nc.affine_from_points([oracle.generator(J_BLS)])
    aff = nc.to_affine(nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), k))
    pts = nc.affine_to_points(aff)
    ks = oracle.random_scalars(J_BLS, n, seed=93)
    want = nc.affine_to_points(nc.to_affine(nc.msm(aff, nc.scalars_from_ints(ks))[None, :]))[0]
    assert _coz(BLS12_381_G1, pts, ks) == want


def test_identities_and_zero_scalars():
    n = 40
    pts = oracle.random_points(J_BN, n, seed=94)
    ks = oracle.random_scalars(J_BN, n, seed=95)
    for i in (0, 7, 8):
        pts[i] = None
    for i in (1, 8, 20):
        ks[i] = 0
    assert _coz(BN254_G1, pts, ks, window_size=4) == oracle.msm(J_BN, pts, ks)


def test_all_scalars_equal():
    n = 64
    pts = oracle.random_points(J_BN, n, seed=96)
    ks = [oracle.random_scalars(J_BN, 1, seed=97)[0]] * n
    assert _coz(BN254_G1, pts, ks, window_size=4) == oracle.msm(J_BN, pts, ks)


def test_cancelling_pairs():
    """P_i and -P_i under one scalar cancel: the co-Z add yields (0, 0)
    inside the rounds.  Eleven pairs cancel; the twelfth does not."""
    half = oracle.random_points(J_BN, 12, seed=98)
    pts = half + [oracle.neg(J_BN, p) for p in half]
    ks = oracle.random_scalars(J_BN, 12, seed=99) * 2
    pts[3] = oracle.random_points(J_BN, 1, seed=100)[0]
    assert _coz(BN254_G1, pts, ks, window_size=4) == oracle.msm(J_BN, pts, ks)


@pytest.mark.parametrize("w", [2, 8])
def test_windows(w):
    n = 24
    pts = oracle.random_points(J_BN, n, seed=101 + w)
    ks = oracle.random_scalars(J_BN, n, seed=102 + w)
    ks[4] = ks[5]
    assert _coz(BN254_G1, pts, ks, window_size=w) == oracle.msm(J_BN, pts, ks)


def test_chunked_multiexp():
    """n = 21 with chunk_size 16: two co-Z chunks added on the device."""
    n = 21
    pts = oracle.random_points(J_BN, n, seed=103)
    ks = oracle.random_scalars(J_BN, n, seed=104)
    assert _coz(BN254_G1, pts, ks, window_size=5, chunk_size=16) == oracle.msm(J_BN, pts, ks)


def test_window_model_and_plan_match_tpu_ec():
    from tpu_ec.ops.msm_coz import default_window_size_coz as j_default
    from tpu_ec.ops.msm_sorted import _plan_sizes as j_plan

    for log_n in range(0, 25):
        assert default_window_size_coz(1 << log_n) == j_default(1 << log_n)
        for w in (4, 13):
            assert _plan_sizes(1 << log_n, 1 << (w - 1)) == j_plan(1 << log_n, 1 << (w - 1))


def test_unported_engines_raise():
    """Every engine of tpu_ec's multiexp is ported: "sorted" runs, and only a
    name no engine has raises."""
    kern = MultiexpKernel(BN254_G1, "cpu")
    jpts = oracle.random_points(J_BN, 2, seed=105)
    pts = kern.ops.from_affine_ints(jpts)
    out = kern.multiexp(pts, kern.ops.scalars_to_limbs([1, 2]), method="sorted", window_size=8)
    assert kern.ops.to_affine_ints(kern.ops.to_affine(out))[0] == oracle.msm(J_BN, jpts, [1, 2])
    with pytest.raises(ValueError, match="unknown MSM method"):
        kern.multiexp(pts, kern.ops.scalars_to_limbs([1, 2]), method="bogus")
