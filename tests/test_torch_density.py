"""The port's density tracking, sparse and coefficient-basis commits, and entry point.

- ``DensityTracker`` (ops/density.py) against tpu_ec's on seeded sequences
  of ``add_element``, ``inc`` and ``extend`` with both values of
  ``is_input_density``, empty trackers included; ``FullDensity``;
- ``compact_by_density`` equal to tpu_ec's, with ``skip`` 0 and > 0;
- ``CommitPipeline.commit_coefficient_basis`` and ``commit_sparse`` at BN254
  n = 64 against the native C++ Pippenger over the same terms (not tpu_ec's
  MSM, whose CPU compile takes minutes);
- ``tpu_ec_torch.entry.entry(device="cpu")`` runs, and its commitment
  equals the native one.

Inputs come from numpy and ``random`` seeds; tolerance: none (integers).
"""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BN254_G1 as J_BN
from tpu_ec.native import native_curve
from tpu_ec.ops import density as jd
from tpu_ec_torch.convert import limbs_to_numpy, limbs_to_torch, points_to_torch
from tpu_ec_torch.curves import BN254_G1
from tpu_ec_torch.ops import density as td
from tpu_ec_torch.ops.pipeline import CommitPipeline


def _same(t, j):
    return [bool(b) for b in t.bv] == j.bv and t.get_total_density() == j.get_total_density() and (
        t.get_query_size() == j.get_query_size()) and np.array_equal(
        t.generate_mask(len(t.bv)), j.generate_mask(len(j.bv)))


def _grow(rng, pair, steps):
    """The same random add_element / inc steps on both trackers of ``pair``."""
    for _ in range(steps):
        if not pair[0].bv or rng.random() < 0.4:
            for t in pair:
                t.add_element()
        else:
            i = rng.randrange(len(pair[0].bv))
            for t in pair:
                t.inc(i)


@pytest.mark.parametrize("seed", range(8))
def test_density_tracker_matches_tpu_ec(seed):
    rng = random.Random(seed)
    a = (td.DensityTracker(), jd.DensityTracker())
    assert _same(*a)
    for _ in range(4):
        other = (td.DensityTracker(), jd.DensityTracker())
        _grow(rng, other, rng.choice([0, 1, 5, 20]))  # 0: an empty tracker
        if rng.random() < 0.5:  # force the index-0 OR of input densities
            for t in other:
                if t.bv:
                    t.inc(0)
        is_input = rng.random() < 0.5
        a[0].extend(other[0], is_input)
        a[1].extend(other[1], is_input)
        assert _same(*a)
        _grow(rng, a, rng.choice([0, 3]))
        assert _same(*a)
    assert td.FullDensity().get_query_size() is None
    n = len(a[0].bv)
    assert np.array_equal(td.FullDensity().generate_mask(n), jd.FullDensity().generate_mask(n))


def test_extend_merges_input_density_at_index_0():
    a, b = td.DensityTracker(), td.DensityTracker()
    for t in (a, b):
        t.add_element()
        t.add_element()
    b.inc(0)
    b.inc(1)
    a.extend(b, True)
    assert list(a.bv) == [1, 0, 1] and a.get_total_density() == 2
    a.extend(b, False)
    assert list(a.bv) == [1, 0, 1, 1, 1] and a.get_total_density() == 4
    assert np.array_equal(td.DensityTracker([True, False, True], 2).generate_mask(3), [True, False, True])
    with pytest.raises(ValueError, match="density length"):
        a.generate_mask(4)


@pytest.mark.parametrize("skip", [0, 5])
def test_compact_by_density_matches_tpu_ec(skip):
    rng = np.random.default_rng(80 + skip)
    n = 40
    dens = (td.DensityTracker(), jd.DensityTracker())
    for t in dens:
        for i in range(n):
            t.add_element()
    for i in np.nonzero(rng.random(n) < 0.5)[0]:
        for t in dens:
            t.inc(int(i))
    bases = tuple(rng.integers(0, 1 << 16, (n + skip, 16), dtype=np.int64) for _ in range(2))
    scalars = rng.integers(0, 1 << 16, (n, 16), dtype=np.int64)
    jb, js = jd.compact_by_density(dens[1], tuple(b.astype(np.uint32) for b in bases), scalars.astype(np.uint32),
                                   skip=skip)
    tb, ts = td.compact_by_density(dens[0], points_to_torch(bases, "cpu"), limbs_to_torch(scalars, "cpu"), skip=skip)
    assert all(np.array_equal(limbs_to_numpy(t), np.asarray(j)) for t, j in zip(tb, jb))
    assert np.array_equal(limbs_to_numpy(ts), np.asarray(js))
    full_b, full_s = td.compact_by_density(td.FullDensity(), points_to_torch(bases, "cpu"), limbs_to_torch(scalars, "cpu"))
    assert torch.equal(full_s, limbs_to_torch(scalars, "cpu")) and full_b[0].shape[0] == n


@pytest.fixture(scope="module")
def srs():
    """(native curve, affine (m, 2w) u64 points k*G, their port (x, y))."""
    nc = native_curve(J_BN)
    m = 72
    rng = np.random.default_rng(81)
    ks = np.zeros((m, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, m, dtype=np.uint64)
    G = nc.affine_from_points([oracle.generator(J_BN)])
    aff = nc.to_affine(nc.scalar_mul(np.broadcast_to(G, (m, G.shape[1])).copy(), ks))
    w = nc.w
    return nc, aff, points_to_torch((nc.fq.to_halflimbs(aff[:, :w]), nc.fq.to_halflimbs(aff[:, w:])), "cpu")


def _native(nc, aff, ints):
    return nc.affine_to_points(nc.to_affine(nc.msm(aff, nc.scalars_from_ints(ints))[None, :]))[0]


def test_commit_coefficient_basis_vs_native(srs):
    nc, aff, bases = srs
    n = 64
    pipe = CommitPipeline(BN254_G1, "cpu")
    ints = [random.Random(82).randrange(J_BN.scalar.modulus) for _ in range(n)]
    ints[3] = 0
    got = pipe.commit_coefficient_basis(pipe.fr.from_ints(ints), tuple(c[:n] for c in bases))
    assert pipe.ops.to_affine_ints(pipe.ops.to_affine(got))[0] == _native(nc, aff[:n], ints)


@pytest.mark.parametrize("skip", [0, 8])
def test_commit_sparse_vs_native(srs, skip):
    nc, aff, bases = srs
    n = 64
    rng = random.Random(83 + skip)
    dens = td.DensityTracker()
    for i in range(n):
        dens.add_element()
        if rng.random() < 0.5:
            dens.inc(i)
    ints = [rng.randrange(J_BN.scalar.modulus) for _ in range(n)]
    pipe = CommitPipeline(BN254_G1, "cpu")
    got = pipe.commit_sparse(pipe.fr.from_ints(ints), bases, dens, skip=skip)
    idx = [i for i in range(n) if dens.bv[i]]
    want = _native(nc, aff[[i + skip for i in idx]], [ints[i] for i in idx])
    assert pipe.ops.to_affine_ints(pipe.ops.to_affine(got))[0] == want


def test_entry_commits_on_the_cpu():
    from tpu_ec_torch.entry import entry

    fn, (coeffs, points) = entry(device="cpu")
    evals, commitment = fn(coeffs, points)
    assert evals.shape == (64, 16) and commitment[0].shape == (1, 16)
    nc = native_curve(J_BN)
    aff = np.concatenate([nc.fq.from_halflimbs(limbs_to_numpy(c).astype(np.uint64)) for c in points], axis=1)
    pipe = CommitPipeline(BN254_G1, "cpu")
    assert pipe.ops.to_affine_ints(pipe.ops.to_affine(commitment))[0] == _native(nc, aff, pipe.fr.to_ints(evals))
    assert all(oracle.is_on_curve(J_BN, p) for p in pipe.ops.to_affine_ints(points))
