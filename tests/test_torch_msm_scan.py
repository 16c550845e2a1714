"""The port's scan engine and the masked scans of the bucket tail.

``masked_prefix_scan_add`` + ``masked_tree_sum`` and ``bucket_tail`` (every
engine's triangular tail, which calls them) against tpu_ec/ops/msm_scan.py's masked scans on
(2, 3, 8) Jacobian rows with identity rows: coordinates equal bit for bit.
``multiexp(method="scan")`` against the bigint oracle, as
tests/test_msm_scan.py holds tpu_ec's engine (its edge cases: identities,
zero scalars, equal keys, cancelling pairs; BLS12-381 at a size that is no
power of two).  Tolerance: none (integers).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_BLS, BN254_G1 as J_BN
from tpu_ec_torch.convert import points_to_numpy
from tpu_ec_torch.curves import BLS12_381_G1, BN254_G1, PointOps
from tpu_ec_torch.ops.msm import MultiexpKernel
from tpu_ec_torch.ops.msm_scan import bucket_tail, masked_prefix_scan_add, masked_tree_sum


def test_masked_scans_match_tpu_ec():
    from tpu_ec.curves.point import point_ops
    from tpu_ec.ops import msm_scan as j_scan

    ops = PointOps(BN254_G1, "cpu")
    L = ops.L
    A = ops.from_affine_ints(oracle.random_points(J_BN, 48, seed=400))
    x = torch.cat(ops.double(ops.to_jacobian(A)), dim=-1).reshape(2, 3, 8, 3 * L)  # z != 1
    x[0, 1, 2] = 0  # identity rows
    x[1, 2, 0] = 0
    jops = point_ops(J_BN)
    xj = np.concatenate(points_to_numpy(tuple(x[..., i * L : (i + 1) * L] for i in range(3))), axis=-1)
    pre_j = j_scan.masked_prefix_scan_add(jops, xj, L, 8)
    want = np.asarray(j_scan.masked_tree_sum(jops, pre_j, L, 8))

    pre = masked_prefix_scan_add(ops, x, L, 8)
    assert np.array_equal(pre.numpy().astype(np.uint32), np.asarray(pre_j))
    tri = masked_tree_sum(ops, pre, L, 8)
    assert np.array_equal(tri.numpy().astype(np.uint32), want)
    # bucket_tail reads slots 1..8 of (..., 10, 3L) buckets, reversed
    junk = torch.full_like(x[..., :1, :], 7)
    got = bucket_tail(ops, torch.cat([junk, x.flip(-2), junk], dim=-2), 8)
    assert np.array_equal(got.numpy().astype(np.uint32), want)


def _scan(tspec, jspec, pts, ks, w=4):
    kern = MultiexpKernel(tspec, "cpu")
    ops = kern.ops
    out = kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), window_size=w, method="scan")
    assert ops.to_affine_ints(ops.to_affine(out))[0] == oracle.msm(jspec, pts, ks)


def test_scan_msm_edge_cases_vs_oracle():
    """Identities and zero scalars, a run of equal points and scalars (the
    segmented scan's long run), and k, -k on the same point."""
    n = 32
    pts = oracle.random_points(J_BN, n, seed=401)
    ks = oracle.random_scalars(J_BN, n, seed=402)
    pts[0] = pts[1] = None
    ks[2] = ks[3] = 0
    pts[8:16] = [pts[8]] * 8
    ks[8:16] = [ks[8]] * 8
    pts[20], ks[20] = pts[21], J_BN.scalar.modulus - ks[21]
    _scan(BN254_G1, J_BN, pts, ks)


def test_scan_msm_bls_non_pow2():
    pts = oracle.random_points(J_BLS, 21, seed=403)
    ks = oracle.random_scalars(J_BLS, 21, seed=404)
    _scan(BLS12_381_G1, J_BLS, pts, ks, w=5)
