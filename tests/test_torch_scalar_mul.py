"""The port's scalar multiplication, sub, eq and neg_affine against tpu_ec's PointOps.

One batch of 8 BLS12-381 G1 points goes through tpu_ec's ``scalar_mul``
(jnp, 256 double-and-add steps) and the port's (kernel K3's chain entry;
its plain version on the CPU), in one call: the P rows include the identity
and a "garbage" identity (z = 0 with x, y != 0, as P - P leaves it), the
scalars 0, 1, 2, r - 1, r + 2 (its last add meets acc == P), 2^256 - 1 and
random values.  A second batch of
small scalars takes the chain's two shortcuts (the steps above the top set
bit, the adds of the zero bits) on every row.  Jacobian coordinates must be
equal bit for bit.  Inputs come from oracle seeds; tolerance: none
(integers).
"""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax
import jax.numpy as jnp
import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_G1
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec_torch.convert import limbs_to_torch, points_to_numpy, points_to_torch
from tpu_ec_torch.curves import BLS12_381_G1, PointOps

R = J_G1.scalar.modulus


@pytest.fixture(scope="module")
def batch():
    """(tpu_ec PointOps, the port's, P (8 Jacobian rows, z != 1), Q, the
    jitted tpu_ec scalar_mul)."""
    jops = j_point_ops(J_G1)
    A = jops.from_affine_ints(oracle.random_points(J_G1, 8, seed=50))
    P = jops.add_mixed(jops.double(jops.to_jacobian(A)), A)  # 3A, z != 1
    garbage = jops.sub(P, P)  # z = 0, x = rr^2, y = -rr^3
    ident = jops.identity_jacobian((8,))
    row = jnp.arange(8)
    P = jops.select(row == 0, ident, jops.select(row == 1, garbage, P))
    P = tuple(np.asarray(c) for c in P)
    assert not np.asarray(P[2][1]).any() and np.asarray(P[0][1]).any(), "row 1: a garbage identity"
    # Q: P's points with other z (row 2), -P (row 3), the identity (row 4),
    # other points elsewhere
    F = jops.F
    lam = F.from_ints([5])
    lam2 = F.sqr(lam)
    scaled = (F.mul(P[0], lam2), F.mul(P[1], F.mul(lam2, lam)), F.mul(P[2], lam))
    B = jops.to_jacobian(jops.from_affine_ints(oracle.random_points(J_G1, 8, seed=51)))
    Q = jops.select(row == 2, scaled, B)
    Q = jops.select(row == 3, jops.neg(P), Q)
    Q = jops.select(row == 4, ident, Q)
    Q = tuple(np.asarray(c) for c in Q)
    smul = jax.jit(lambda P, k: jops.scalar_mul(P, k))
    return jops, PointOps(BLS12_381_G1, "cpu"), P, Q, smul


def _same(got, want):
    return all(np.array_equal(g, np.asarray(w)) for g, w in zip(points_to_numpy(got), want))


def _limbs(ks):
    """Plain scalars (any 256-bit value) -> (n, 16) uint32 half-limbs."""
    return np.stack([[(k >> (16 * i)) & 0xFFFF for i in range(16)] for k in ks]).astype(np.uint32)


def test_scalar_mul_edge_scalars(batch):
    jops, tops, P, _, smul = batch
    rng = random.Random(52)
    # row 0 (identity) and row 1 (garbage identity) take long scalars; at
    # row 6 the last add finds acc == [r + 1] P == P and doubles
    ks = [2**256 - 1, R - 1, 0, 1, 2, rng.randrange(R), R + 2, rng.randrange(2**256)]
    k = _limbs(ks)
    want = smul(P, jnp.asarray(k))
    got = tops.scalar_mul(points_to_torch(P, "cpu"), limbs_to_torch(k, "cpu"))
    assert _same(got, want)


def test_scalar_mul_shortcuts(batch):
    """Small scalars: every row starts at its own top bit and skips the adds
    of its zero bits; one scalar for every row (k of shape (16,)) equals it
    spelled out per row."""
    jops, tops, P, _, smul = batch
    ks = [5, 0, 7, 1, 2, 6, 4, 3]
    k = _limbs(ks)
    got = tops.scalar_mul(points_to_torch(P, "cpu"), limbs_to_torch(k, "cpu"))
    assert _same(got, smul(P, jnp.asarray(k)))
    one = limbs_to_torch(k[0], "cpu")
    assert _same(tops.scalar_mul(points_to_torch(P, "cpu"), one),
                 points_to_numpy(tops.scalar_mul(points_to_torch(P, "cpu"), one.expand(8, -1))))


def test_sub(batch):
    jops, tops, P, Q, _ = batch
    tP, tQ = points_to_torch(P, "cpu"), points_to_torch(Q, "cpu")
    assert _same(tops.sub(tP, tQ), jops.sub(P, Q))
    assert _same(tops.sub(tP, tP), jops.sub(P, P))  # P - P: identities with x, y != 0


def test_eq(batch):
    jops, tops, P, Q, _ = batch
    tP, tQ = points_to_torch(P, "cpu"), points_to_torch(Q, "cpu")
    for a, b, ta, tb in ((P, Q, tP, tQ), (P, P, tP, tP), (Q, P, tQ, tP)):
        want = np.asarray(jops.eq(a, b))
        assert np.array_equal(tops.eq(ta, tb).numpy(), want)
    assert np.asarray(jops.eq(P, Q))[2] and not np.asarray(jops.eq(P, Q))[5]  # same point, other z; others differ


def test_neg_affine(batch):
    jops, tops, _, _, _ = batch
    A = tuple(np.asarray(c) for c in jops.from_affine_ints([None] + oracle.random_points(J_G1, 7, seed=53)))
    assert not A[1][0].any()  # row 0: the identity, (0, 0)
    assert _same(tops.neg_affine(points_to_torch(A, "cpu")), jops.neg_affine(A))
