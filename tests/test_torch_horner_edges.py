"""The Horner window combine's plain version against tpu_ec on its edge cases.

K3's Horner entry (one tile of lanes a chunk on the card) is held bit for
bit against ``horner_plain`` on the card (tests/test_torch_cuda.py); here
``horner_plain``, and ``horner`` on CPU tensors (the single-MSM form), are
held against tpu_ec's ``msm_batch.horner_combine_batch`` (the per-chunk
``msm_pair.horner_combine`` vectorised across chunks; tests/
test_torch_point.py holds the single form against that one too) on the
cases the kernel must get right, on BN254 and BLS12-381 G1: w = 0,
W = 1, a window sum equal to the running result (the add's P == Q branch),
one equal to its negation (the cancel), identity sums with z = 0 and x, y
!= 0 (as P - P leaves them), every window the identity, and top windows
the identity (the kernel skips the doublings of an all-zero result).  The
last rests on a fact pinned here too: the double of (0, 0, 0) is (0, 0, 0)
in tpu_ec and in the port.

Cost: tpu_ec's combine is one jitted program a curve, with w traced, so
every w and both W reuse it; XLA compiles it in ~10 s a curve on a cold
cache at its lowest backend optimisation (integer results do not depend on
it), which is most of this file's time.
Inputs come from oracle seeds; tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax
import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves import params as jparams
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec.ops.msm_batch import horner_combine_batch
from tpu_ec_torch import curves
from tpu_ec_torch.convert import points_to_numpy, points_to_torch
from tpu_ec_torch.kernels.point import horner, horner_plain, point_op_plain

W = 3  # windows of the batch cases
CASES = ("random", "same", "cancel", "garbage identity", "all identity", "top identity", "top two identity")


def _jac(jops, pts):
    """Affine oracle points (None = identity) -> tpu_ec Jacobian numpy (z = 1, or 0, 0, 0)."""
    return tuple(map(np.asarray, jops.to_jacobian(jops.from_affine_ints(pts))))


def _sums(spec, jops, w, seed):
    """(W, C, L) window sums, one chunk a case of CASES; chunk c's windows
    j = W-1 .. 0 are added top first."""
    pts = oracle.random_points(spec, 2 * W * len(CASES), seed=seed)
    S = [[pts[W * c + j] for j in range(W)] for c in range(len(CASES))]  # S[c][j]
    P = S[1][2]  # the running result after the top window, before 2^w
    S[1][1] = oracle.scalar_mul(spec, P, 1 << w)  # == 2^w P: the add's P == Q branch
    S[2][1] = oracle.neg(spec, oracle.scalar_mul(spec, S[2][2], 1 << w))  # == -2^w P: the cancel
    S[4] = [None] * W
    S[5][2] = None
    S[6][2] = S[6][1] = None
    cols = [_jac(jops, [S[c][j] for c in range(len(CASES))]) for j in range(W)]
    sums = tuple(np.stack([cols[j][k] for j in range(W)]) for k in range(3))
    # chunk 3: identity sums with z = 0, x, y != 0 in the top and the middle windows
    for j in (2, 1):
        g = _jac(jops, [pts[-1 - j]])
        sums[0][j, 3], sums[1][j, 3], sums[2][j, 3] = g[0][0], g[1][0], 0
    return sums


@pytest.fixture(scope="module", params=["BN254_G1", "BLS12_381_G1"])
def curve(request):
    """(tpu_ec PointOps, the port's curve, tpu_ec's batched combine of (W, C)
    sums compiled once with w traced)."""
    jops = j_point_ops(getattr(jparams, request.param))
    S = _sums(jops.spec, jops, 0, seed=0)
    batch = jax.jit(lambda S, w: horner_combine_batch(jops, S, w)).lower(S, np.int32(0)).compile(
        {"xla_backend_optimization_level": 0, "xla_llvm_disable_expensive_passes": True})
    return jops, getattr(curves, request.param), lambda S, w: batch(S, np.int32(w))


def _same(got, want):
    return all(np.array_equal(g, np.asarray(x)) for g, x in zip(points_to_numpy(got), want))


@pytest.mark.parametrize("w", [0, 1, 5])
def test_horner_edges_match_tpu_ec(curve, w):
    """Every case chunk of a (3, 7) batch, and each chunk as one MSM."""
    jops, spec, batch = curve
    S = _sums(jops.spec, jops, w, seed=40 + w)
    want = tuple(map(np.asarray, batch(S, w)))
    got = horner_plain(spec.base, points_to_torch(S, "cpu"), w)
    assert _same(got, want)
    assert all(not c[4].any() for c in want)  # every window the identity: (0, 0, 0)
    for c in range(len(CASES)):
        one = horner(spec.base, points_to_torch(tuple(x[:, c] for x in S), "cpu"), w)
        assert _same(one, tuple(x[c : c + 1] for x in want)), CASES[c]


@pytest.mark.parametrize("w", [0, 3])
def test_horner_one_window_matches_tpu_ec(curve, w):
    """W = 1: its one window against tpu_ec's combine of the same sums under
    two identity windows (the same coordinates, since tpu_ec doubles (0, 0,
    0) to (0, 0, 0), pinned below, and adds the identity to it as a copy)."""
    jops, spec, batch = curve
    S = _sums(jops.spec, jops, w, seed=50 + w)
    top = tuple(np.concatenate([x[:1], np.zeros_like(x[1:])]) for x in S)
    want = batch(top, w)
    got = horner_plain(spec.base, points_to_torch(tuple(x[:1] for x in S), "cpu"), w)
    assert _same(got, want)


def test_double_of_zero_is_zero(curve):
    """The identity skip's fact: dbl-2009-l maps (0, 0, 0) to (0, 0, 0) in
    tpu_ec's PointOps.double and in the port's plain double."""
    jops, spec, _ = curve
    zero = jops.identity_jacobian((2,))
    assert all(not np.any(np.asarray(c)) for c in jops.double(zero))
    z = torch.zeros((2, spec.base.n_limbs), dtype=torch.int64)
    assert all(not bool(c.any()) for c in point_op_plain(spec.base, "double", [z, z, z]))
