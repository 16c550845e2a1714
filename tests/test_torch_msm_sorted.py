"""The port's sorted MSM engine (``multiexp(method="sorted")``) against the referees.

The cases of tests/test_msm_sorted.py against the bigint oracle
(``tpu_ec.curves.oracle.msm``): n = 1, 2 and 33; identity bases and zero
scalars; all scalars equal (one maximal run per window: the constant-size
fix-up rounds run to their worst-case depth); repeated bases (the doubling
branch inside the halving rounds); window 8; BLS12-381 G2 (the chunked
path is the engines' shared ``_multiexp_chunked``, tested with the co-Z
engine).  tpu_ec's own engine takes minutes of XLA-CPU compile
(its tests are slow-marked), so the Jacobian bits are held against tpu_ec
one halving round at a time (``_halving_round``, the affine first round
and a Jacobian round), which tpu_ec runs eagerly in seconds.  Tolerance:
none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax.numpy as jnp
import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G2 as J_BLS2
from tpu_ec.curves.params import BN254_G1 as J_BN
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec.ops import msm_sorted as jsorted
from tpu_ec_torch.curves import BLS12_381_G2, BN254_G1, PointOps
from tpu_ec_torch.ops import msm_sorted as tsorted
from tpu_ec_torch.ops.msm import MultiexpKernel
from tpu_ec_torch.ops.msm_scan import _fuse, _unfuse


def _sorted(tspec, jspec, pts, ks, chunk_size=None, **kw):
    kern = MultiexpKernel(tspec, "cpu", chunk_size=chunk_size)
    ops = kern.ops
    out = kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), method="sorted", **kw)
    assert out[0].shape == (1, ops.width)
    assert ops.to_affine_ints(ops.to_affine(out))[0] == oracle.msm(jspec, pts, ks)


@pytest.mark.parametrize("n", [1, 2, 33])
def test_small_vs_oracle(n):
    _sorted(BN254_G1, J_BN, oracle.random_points(J_BN, n, seed=n), oracle.random_scalars(J_BN, n, seed=n + 1),
            window_size=4)


def test_identities_and_zero_scalars():
    n = 64
    pts = oracle.random_points(J_BN, n, seed=2)
    ks = oracle.random_scalars(J_BN, n, seed=3)
    pts[0] = pts[5] = None
    ks[1] = ks[2] = 0
    _sorted(BN254_G1, J_BN, pts, ks, window_size=4)


def test_adversarial_equal_scalars():
    """All scalars equal: one run of n entries a window; the fix-up rounds
    finish what the shrinking rounds leave (runs of ~n / 2^rounds)."""
    n = 64
    k = oracle.random_scalars(J_BN, 1, seed=5)[0]
    assert tsorted._plan_sizes(n, 8)  # the shrinking rounds leave long runs behind
    _sorted(BN254_G1, J_BN, oracle.random_points(J_BN, n, seed=4), [k] * n, window_size=4)


def test_duplicate_points():
    n = 64
    base = oracle.random_points(J_BN, 4, seed=6)
    _sorted(BN254_G1, J_BN, [base[i % 4] for i in range(n)], oracle.random_scalars(J_BN, n, seed=7), window_size=4)


@pytest.mark.parametrize("w", [8])
def test_window_sweep(w):
    n = 40
    _sorted(BN254_G1, J_BN, oracle.random_points(J_BN, n, seed=w), oracle.random_scalars(J_BN, n, seed=w + 1),
            window_size=w)


def test_bls12_381_g2():
    n = 9
    _sorted(BLS12_381_G2, J_BLS2, oracle.random_points(J_BLS2, n, seed=10), oracle.random_scalars(J_BLS2, n, seed=11),
            window_size=4)


def test_default_window_matches_tpu_ec():
    for log_n in range(0, 27):
        for n in {max(1, (1 << log_n) - 1), 1 << log_n}:
            assert tsorted.default_window_size_sorted(n) == jsorted.default_window_size_sorted(n)


def test_rounds_match_sorted_steps(monkeypatch):
    """The engine runs the halving and fix-up rounds ``sorted_steps``
    counts (one K3 launch each on the card)."""
    calls = []
    real = tsorted._halving_round

    def counted(*a, **kw):
        calls.append(kw["affine"])
        return real(*a, **kw)

    monkeypatch.setattr(tsorted, "_halving_round", counted)
    n, w = 64, 3
    _sorted(BN254_G1, J_BN, oracle.random_points(J_BN, n, seed=12), oracle.random_scalars(J_BN, n, seed=13),
            window_size=w)
    steps = tsorted.sorted_steps(n, w)
    assert len(calls) == steps["halving"] + steps["fixup"]
    assert calls[0] and not any(calls[1:])


def test_halving_rounds_match_tpu_ec():
    """One affine round, then one Jacobian round, on keys with runs of
    every length parity (a sorted key vector with repeats): the survivors'
    keys and Jacobian bits equal tpu_ec's ``_halving_round``."""
    n, half = 40, 8
    rng = np.random.default_rng(21)
    keys = np.sort(rng.integers(0, half + 1, n)).astype(np.int32)
    pts = oracle.random_points(J_BN, n, seed=22)
    pts[3] = None  # an identity entry
    starts = [i for i in range(n) if i == 0 or keys[i] != keys[i - 1]]
    i = next(i for i in range(n - 1) if keys[i + 1] == keys[i] and (i - max(t for t in starts if t <= i)) % 2 == 0)
    pts[i + 1] = pts[i]  # a pair that adds a point to itself: the doubling branch
    ops, jops = PointOps(BN254_G1, "cpu"), j_point_ops(J_BN)
    A, jA = ops.from_affine_ints(pts), jops.from_affine_ints(pts)
    s1 = n // 2 + half // 2 + 3
    s2 = s1 // 2 + half // 2 + 3
    k1, d1 = tsorted._halving_round(ops, torch.as_tensor(keys), _fuse(A), s1, affine=True)
    jk1, jP1 = jsorted._halving_round(ops=jops, key=jnp.asarray(keys), P=jA, s_out=s1, affine=True)
    k2, d2 = tsorted._halving_round(ops, k1, d1, s2, affine=False)
    jk2, jP2 = jsorted._halving_round(jops, jk1, jP1, s2, affine=False)
    for k, d, jk, jP in ((k1, d1, jk1, jP1), (k2, d2, jk2, jP2)):
        assert np.array_equal(k.numpy(), np.asarray(jk))
        for c, jc in zip(_unfuse(d, ops.width, 3), jP):
            assert np.array_equal(c.numpy(), np.asarray(jc).astype(np.int64))
