"""Edge cases of the port's pair-halving MSM engine against the bigint oracle.

As tests/test_msm_pair.py does for tpu_ec's engine: all scalars equal (one
maximal run per window), zero scalars and identity bases (digit-0 dummy slot,
identity encoding), every digit distinct (maximal spill pressure, the spill
cap #runs <= 2^(w-1) + 1 tight), duplicates, a non-power-of-two size, and
the chunked path.  tpu_ec's own pair engine is not called here: its CPU
compile takes minutes.  Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_BLS, BN254_G1 as J_BN
from tpu_ec_torch.curves import BLS12_381_G1, BN254_G1
from tpu_ec_torch.ops.msm import MultiexpKernel
from tpu_ec_torch.ops.msm_pair import default_window_size_pair


def _run(tspec, jspec, pts, ks, **kw):
    kern = MultiexpKernel(tspec, "cpu", chunk_size=kw.pop("chunk_size", None))
    ops = kern.ops
    out = kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), **kw)
    assert ops.to_affine_ints(ops.to_affine(out))[0] == oracle.msm(jspec, pts, ks)


def test_identities_zero_scalars_duplicates():
    n = 64
    pts = oracle.random_points(J_BN, n, seed=82)
    ks = oracle.random_scalars(J_BN, n, seed=83)
    pts[0] = None  # identity base
    ks[1] = 0  # zero scalar: every digit lands in the dummy slot
    pts[3], ks[3] = pts[2], ks[2]  # duplicate point and scalar: doubling path
    _run(BN254_G1, J_BN, pts, ks, window_size=4)


def test_all_scalars_equal():
    n = 64
    pts = oracle.random_points(J_BN, n, seed=84)
    ks = [oracle.random_scalars(J_BN, 1, seed=85)[0]] * n
    _run(BN254_G1, J_BN, pts, ks, window_size=4)


def test_spill_heavy_singletons():
    """Scalars 1..n with a 4-bit window: every pair is a boundary pair."""
    n = 64
    pts = oracle.random_points(J_BN, n, seed=86)
    _run(BN254_G1, J_BN, pts, list(range(1, n + 1)), window_size=4)


def test_bls_non_pow2_and_chunked():
    """n = 21 pads to 32 with identity rows; chunk_size 16 splits it in two
    and adds the partial sums on the device."""
    n = 21
    pts = oracle.random_points(J_BLS, n, seed=87)
    ks = oracle.random_scalars(J_BLS, n, seed=88)
    ks[5] = 0
    _run(BLS12_381_G1, J_BLS, pts, ks, window_size=5, chunk_size=16)


def test_default_window_matches_tpu_ec_model():
    from tpu_ec.ops.msm_pair import default_window_size_pair as j_default

    for log_n in range(1, 25):
        assert default_window_size_pair(1 << log_n) == j_default(1 << log_n)
