"""Shared cases of the G2 point-op tests (test_torch_g2_point_bls.py and
test_torch_g2_point_bn.py; this file has no tests of its own): the port's
G2 PointOps against tpu_ec's on one curve.

A batch of 12 rows from the bigint oracle, with the select tree's edges:
row 0 P = identity, 1 Q = A = identity, 2 Q == P (other z) and A == P,
3 Q == -P and A == -P, 4 both identity, 5 P a garbage identity (z = 0 with
x, y != 0, as P - P leaves it).  Jacobian coordinates must be equal bit for
bit; tolerance: none (integers).
"""

import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec_torch.convert import g2_points_to_numpy, g2_points_to_torch
from tpu_ec_torch.curves import PointOps

N = 12


def make_batch(jspec, tspec, seed):
    """(tpu_ec PointOps, the port's, P, Q (Jacobian), A, PA (affine)) as
    tpu_ec pytrees of numpy (c0, c1) pairs."""
    jops = j_point_ops(jspec)
    pts = oracle.random_points(jspec, N, seed=seed)
    qts = oracle.random_points(jspec, N, seed=seed + 1)
    pts[0] = None
    qts[1] = None
    qts[2] = pts[2]
    qts[3] = oracle.neg(jspec, pts[3])
    pts[4] = qts[4] = None
    PA, A = jops.from_affine_ints(pts), jops.from_affine_ints(qts)
    P = jops.add_mixed(jops.double(jops.to_jacobian(PA)), PA)  # 3 PA, z != 1
    Q = jops.to_jacobian(A)
    garbage = jops.sub(P, P)
    P = jops.select(np.arange(N) == 5, garbage, P)
    np_tree = lambda t: tuple(tuple(np.asarray(c) for c in coord) for coord in t)
    return jops, PointOps(tspec, "cpu"), np_tree(P), np_tree(Q), np_tree(A), np_tree(PA)


def same(got, want):
    """Port coordinates == tpu_ec's (c0, c1) pairs, bit for bit."""
    return all(np.array_equal(g[k], np.asarray(w[k]))
               for g, w in zip(g2_points_to_numpy(got), want) for k in range(2))


def t(pts):
    return g2_points_to_torch(pts, "cpu")


def check_add(batch):
    jops, tops, P, Q, _, _ = batch
    assert np.asarray(P[2][0][5]).sum() == 0 and np.asarray(P[0][0][5]).any(), "row 5: a garbage identity"
    assert same(tops.add(t(P), t(Q)), jops.add(P, Q))


def check_add_mixed(batch):
    jops, tops, P, _, A, PA = batch
    assert same(tops.add_mixed(t(P), t(A)), jops.add_mixed(P, A))
    # P affine, lifted (z = 1, or 0 for (0, 0))
    assert same(tops.add_mixed(t(PA), t(A)), jops.add_mixed(jops.to_jacobian(PA), A))


def check_double_neg_sub(batch):
    jops, tops, P, Q, _, _ = batch
    assert same(tops.double(t(P)), jops.double(P))
    assert same(tops.neg(t(P)), jops.neg(P))
    assert same(tops.sub(t(P), t(Q)), jops.sub(P, Q))


def check_eq_and_to_affine(batch):
    jops, tops, P, Q, _, _ = batch
    assert np.array_equal(tops.eq(t(P), t(Q)).numpy(), np.asarray(jops.eq(P, Q)))
    assert np.array_equal(tops.eq(t(P), t(P)).numpy(), np.asarray(jops.eq(P, P)))
    assert same(tops.to_affine(t(P)), jops.to_affine(P))
    pts = tops.to_affine_ints(tops.to_affine(t(P)))
    assert tops.to_affine_ints(tops.from_affine_ints(pts)) == pts
