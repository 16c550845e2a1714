"""Port point ops (kernel K3's plain version) against tpu_ec's PointOps.

Random BLS12-381 G1 points from the bigint oracle, with identity, P == Q
and P == -Q rows mixed in, go through tpu_ec's PointOps (jnp; its Pallas
kernels are proven bit-identical to it in tests/test_pallas_point.py) and
the port's PointOps on the CPU.  Jacobian coordinates must be equal bit for
bit, not merely the same points.  Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_G1
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec_torch.convert import points_to_numpy, points_to_torch
from tpu_ec_torch.curves import BLS12_381_G1, PointOps
from tpu_ec_torch.errors import DeviceError
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.kernels.point import chain_tile, horner, horner_plain, point_op


@pytest.fixture(scope="module")
def batch():
    jops = j_point_ops(J_G1)
    n = 24
    pts = oracle.random_points(J_G1, n, seed=20)
    qts = oracle.random_points(J_G1, n, seed=21)
    pts[0] = None  # P = identity
    qts[1] = None  # Q = identity
    pts[2] = qts[2]  # P == Q
    qts[3] = oracle.neg(J_G1, pts[3])  # P == -Q
    pts[4] = qts[4] = None  # both identity
    A1 = jops.from_affine_ints(pts)
    A2 = jops.from_affine_ints(qts)
    P = jops.add_mixed(jops.double(jops.to_jacobian(A1)), A1)  # z != 1
    Q = jops.to_jacobian(A2)
    P2 = jops.add_mixed(jops.double(jops.to_jacobian(A2)), A2)  # Q's point, other z
    return jops, PointOps(BLS12_381_G1, "cpu"), [tuple(map(np.asarray, t)) for t in (P, Q, A2, P2, A1)]


def _same(got, want):
    return all(np.array_equal(g, np.asarray(w)) for g, w in zip(points_to_numpy(got), want))


def test_add(batch):
    jops, tops, (P, Q, _, P2, _) = batch
    assert _same(tops.add(points_to_torch(P, "cpu"), points_to_torch(Q, "cpu")), jops.add(P, Q))
    # P == Q with different Jacobian representations takes the doubling
    assert _same(tops.add(points_to_torch(Q, "cpu"), points_to_torch(P2, "cpu")), jops.add(Q, P2))


def test_add_mixed(batch):
    jops, tops, (P, _, A2, _, _) = batch
    assert _same(tops.add_mixed(points_to_torch(P, "cpu"), points_to_torch(A2, "cpu")), jops.add_mixed(P, A2))


def test_double(batch):
    jops, tops, (P, _, _, _, _) = batch
    assert _same(tops.double(points_to_torch(P, "cpu")), jops.double(P))


def test_to_affine(batch):
    jops, tops, (P, _, _, _, _) = batch
    assert _same(tops.to_affine(points_to_torch(P, "cpu")), jops.to_affine(P))


def test_affine_ints_roundtrip():
    tops = PointOps(BLS12_381_G1, "cpu")
    pts = oracle.random_points(J_G1, 3, seed=5) + [None]
    assert tops.to_affine_ints(tops.from_affine_ints(pts)) == pts


def test_non_cpu_tensor_never_takes_the_plain_version():
    c = torch.zeros((4, 24), dtype=torch.int32, device="meta")
    with pytest.raises(DeviceError):
        point_op(BLS12_381_G1.base, "double", [c, c, c])


def _keep_mask(n):
    keep = np.zeros(n, dtype=bool)
    keep[::3] = True
    keep[2] = False  # the P == Q row adds
    return keep


@pytest.mark.parametrize("op", ["add", "add_mixed", "add_mixed_affine"])
def test_keep_and_out(batch, op):
    """The keep / out= entry (the pair MSM's fused rows): where(keep, P,
    P + Q) written side by side into out, against tpu_ec's point ops."""
    jops, tops, (P, Q, A2, _, A1) = batch
    n, L = P[0].shape[0], tops.L
    keep = _keep_mask(n)
    if op == "add":
        Pj, want = P, jops.add(P, Q)
        got_in = (points_to_torch(P, "cpu"), points_to_torch(Q, "cpu"))
    elif op == "add_mixed":
        Pj, want = P, jops.add_mixed(P, A2)
        got_in = (points_to_torch(P, "cpu"), points_to_torch(A2, "cpu"))
    else:  # P affine, lifted to Jacobian in the op
        Pj = tuple(map(np.asarray, jops.to_jacobian(A1)))
        want = jops.add_mixed(Pj, A2)
        got_in = (points_to_torch(A1, "cpu"), points_to_torch(A2, "cpu"))
    want = tuple(np.where(keep[:, None], p, np.asarray(w)) for p, w in zip(Pj, want))
    out = torch.full((n, 3 * L), -1, dtype=got_in[0][0].dtype)
    f = tops.add if op == "add" else tops.add_mixed
    got = f(*got_in, keep=torch.as_tensor(keep), out=out)
    assert _same(got, want)
    assert np.array_equal(out.numpy(), np.concatenate(want, axis=1))


def test_horner_matches_tpu_ec(batch):
    """The Horner window combine (one K3 launch on the card; its plain loop
    here) against tpu_ec/ops/msm_pair.py::horner_combine on 4 windows, one
    of them the identity."""
    from tpu_ec.ops.msm_pair import horner_combine

    jops, tops, (P, _, _, _, _) = batch
    S = tuple(np.array(c[5:9]) for c in P)
    S[2][1] = 0  # window 1 = identity
    want = horner_combine(jops, S, 3)
    assert _same(horner(BLS12_381_G1.base, points_to_torch(S, "cpu"), 3), want)


def test_horner_batch_matches_tpu_ec(batch):
    """The batched Horner combine's plain version (K3's batched entry on
    the card) against tpu_ec/ops/msm_batch.py::horner_combine_batch at
    W = 4, C = 3, w = 3, one (window, chunk) sum the identity: Jacobian
    coordinates equal."""
    from tpu_ec.ops.msm_batch import horner_combine_batch

    jops, tops, (P, _, _, _, _) = batch
    S = tuple(np.array(c[8:20]).reshape(4, 3, -1) for c in P)
    S[2][1, 2] = 0  # window 1 of chunk 2 = identity
    want = horner_combine_batch(jops, S, 3)
    got = horner_plain(BLS12_381_G1.base, points_to_torch(S, "cpu"), 3)
    assert _same(got, want)
    # the single-MSM form is the C = 1 case
    one = horner(BLS12_381_G1.base, points_to_torch(tuple(c[:, 0] for c in S), "cpu"), 3)
    assert all(torch.equal(o, g[:1]) for o, g in zip(one, got))


@pytest.mark.parametrize("name", ["BLS12_381_FQ", "BN254_FQ"])
def test_lazy_reduction_headroom(name):
    """K3 carries values in [0, 2p) and multiplies them without the final
    subtraction; that needs 4p < R = 2^(32 NW) (the product of two values
    below 2p is then (ab + Mp) / R < 2p, and a sum of two stays below R)."""
    spec = getattr(tfp, name)
    nw = spec.n_limbs // 2
    assert 4 * spec.modulus < 1 << (32 * nw)
    assert spec.r == 1 << (32 * nw)


@pytest.mark.parametrize("ext", [0, 3])
def test_chain_tile_rejects_ext(ext):
    with pytest.raises(ValueError):
        chain_tile(tfp.BN254_FQ, ext)
