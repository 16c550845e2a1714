"""The port's distributed MSM on gloo ranks, and its scalar_mul_small.

One spawn of ranks a world size (d = 2 and d = 4, module-scoped,
``tests/torch_dist_ranks.py``) runs BN254 G1 MSMs of n = 32 and of n = 37
(not a multiple of d: ``shard_leading`` pads with identities and zero
scalars) with both bucket accumulations ("pair", "scan"), and at d = 2 a
BN254 G2 MSM of n = 8 on the default accumulation; every rank must
hold the same point, and this process holds it, in affine, against the
bigint oracle and the single-card port at the same window (computed while
the ranks run).  tpu_ec's own
distributed MSM is not run here: its pair accumulation takes minutes of
XLA-CPU compile (tests/test_parallel.py marks it slow).  Jacobian bits
are held against tpu_ec where tpu_ec runs in seconds: ``scalar_mul_small``.
Inputs come from seeds; tolerance: none (integers).
"""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_ranks as ranks
from tpu_ec.curves import oracle
from tpu_ec.curves.params import BN254_G1 as J_BN, BN254_G2 as J_BN2
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec.ops.msm_pair import default_window_size_pair as j_default_pair
from tpu_ec.ops.msm_scan import scalar_mul_small as j_scalar_mul_small
from tpu_ec_torch.config import get_config
from tpu_ec_torch.curves import BN254_G1, BN254_G2, PointOps
from tpu_ec_torch.native import native_curve
from tpu_ec_torch.ops.msm import MultiexpKernel
from tpu_ec_torch.ops.msm_scan import scalar_mul_small
from tpu_ec_torch.parallel.msm_dist import dist_window

SIZES = [(32, None), (37, 5)]  # (n, window): the model's window, and a given one
ACCUMS = ["pair", "scan"]
G2_N = 8  # the G2 case's size (d = 2 only), apart from SIZES: its input files are keyed by n


def _case(n: int):
    return oracle.random_points(J_BN, n, seed=300 + n), oracle.random_scalars(J_BN, n, seed=400 + n)


def _g2_case():
    return oracle.random_points(J_BN2, G2_N, seed=500), oracle.random_scalars(J_BN2, G2_N, seed=501)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{"work": {d: the directory of d's spawn}, "single": {(d, n, accum):
    the single-card engine's point at the distributed window}}, the
    references computed while the ranks run."""
    ops, ops2 = PointOps(BN254_G1, "cpu"), PointOps(BN254_G2, "cpu")
    runs, work = [], {}
    for d in (2, 4):
        work[d] = str(tmp_path_factory.mktemp(f"msm_d{d}"))
        inputs = [(n, ops, *_case(n)) for n, _ in SIZES] + ([(G2_N, ops2, *_g2_case())] if d == 2 else [])
        for n, o, pts, ks in inputs:
            x, y = o.from_affine_ints(pts)
            for name, t in (("x", x), ("y", y), ("s", o.scalars_to_limbs(ks))):
                np.save(os.path.join(work[d], f"msm_{n}_{name}.npy"), t.numpy())
        cases = [(BN254_G1.name, n, accum, w) for n, w in SIZES for accum in ACCUMS]
        if d == 2:
            cases.append((BN254_G2.name, G2_N, None, None))
        runs.append((d, (work[d], [], cases, False, [])))
    spawn = ranks.Spawn(runs)
    single, by_window = {}, {}
    kern = MultiexpKernel(BN254_G1, "cpu")
    for d in (2, 4):
        for n, window in SIZES:
            pts, ks = _case(n)
            w = dist_window(-(-n // d) * d, d, window)
            for accum in ACCUMS:
                if (n, accum, w) not in by_window:
                    out = kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), window_size=w,
                                        method=accum)
                    by_window[n, accum, w] = ops.to_affine_ints(ops.to_affine(out))[0]
                single[d, n, accum] = by_window[n, accum, w]
    spawn.join()
    return {"work": work, "single": single}


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("n,window", SIZES)
@pytest.mark.parametrize("accum", ACCUMS)
def test_dist_msm(runs, d, n, window, accum):
    """The distributed MSM equals the oracle and the single-card engine of
    the same accumulation at the same window, in affine."""
    ops = PointOps(BN254_G1, "cpu")
    pts, ks = _case(n)
    got = np.load(os.path.join(runs["work"][d], ranks.msm_case_name(n, accum, window) + ".npy"))
    got = ops.to_affine_ints(ops.to_affine(tuple(torch.as_tensor(c) for c in got)))[0]
    assert got == oracle.msm(J_BN, pts, ks)
    assert got == runs["single"][d, n, accum]


def test_dist_msm_g2_default_accum_matches_native(runs):
    """BN254 G2 over two ranks on the default accumulation, the pair engine
    (G1-only before it took the coordinate's width): rank 0's point == the
    native Pippenger, in affine."""
    assert get_config().dist_msm_accum == "pair"
    ops = PointOps(BN254_G2, "cpu")
    pts, ks = _g2_case()
    got = np.load(os.path.join(runs["work"][2], ranks.msm_case_name(G2_N, None, None) + ".npy"))
    got = ops.to_affine_ints(ops.to_affine(tuple(torch.as_tensor(c) for c in got)))[0]
    assert got == native_curve(BN254_G2).msm_points(pts, ks)


@pytest.mark.parametrize("n", [1, 32, 37, 1 << 10, 1 << 20])
@pytest.mark.parametrize("d", [1, 2, 4, 64])
def test_dist_window_matches_tpu_ec(n, d):
    """The window: the pair model at the padded global n, raised until every
    rank owns a bucket (tpu_ec/parallel/msm_dist.py:202-205)."""
    n_pad = -(-n // d) * d
    w = j_default_pair(n_pad)
    while (1 << (w - 1)) < d:
        w += 1
    assert dist_window(n_pad, d) == w
    assert dist_window(n_pad, d, 3) == max(3, (d - 1).bit_length() + 1)


def test_scalar_mul_small_matches_tpu_ec():
    """k P for host k < 2^nbits, Jacobian bits equal to tpu_ec's
    double-and-add over nbits (k = 0, 1, 6 and 2^nbits - 1 on four points,
    one of them the identity)."""
    nbits = 4
    pts = oracle.random_points(J_BN, 4, seed=77)
    pts[2] = None
    ops = PointOps(BN254_G1, "cpu")
    jops = j_point_ops(J_BN)
    P = ops.to_jacobian(ops.from_affine_ints(pts))
    jP = jops.to_jacobian(jops.from_affine_ints(pts))
    run = jax.jit(lambda P_, k: j_scalar_mul_small(jops, P_, k, nbits))
    for k in (0, 1, 6, (1 << nbits) - 1):
        got = scalar_mul_small(ops, P, k, nbits)
        want = run(jP, jnp.int32(k))
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w).astype(np.int64))
    with pytest.raises(ValueError, match="not below"):
        scalar_mul_small(ops, P, 1 << nbits, nbits)
