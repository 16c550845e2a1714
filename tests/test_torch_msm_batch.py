"""The port's batch MSM (``MultiexpKernel.multiple_multiexp``) on the CPU.

Every chunk is held against the bigint oracle (``tpu_ec.curves.oracle.msm``)
after ``to_affine``, on the flat one-sort engine ("pair") and on the scan
engine with a chunk axis ("scan"): C = 4 chunks of 16 points at w = 4 with
identity bases, zero scalars, an all-zero chunk and one chunk whose scalars
(and so digits) repeat another's; C * n = 21 rows padded to 32; slabs of
two chunks (a device-memory budget that fits two) against the whole batch; C = 1 against ``multiexp``, bit for bit.
(The batched Horner's plain version is held against tpu_ec's
``horner_combine_batch`` in tests/test_torch_point.py, the masked scans of
the tail against tpu_ec's in tests/test_torch_msm_scan.py.)

The scan batch is held against the oracle, not against tpu_ec's
``multiple_multiexp(method="scan")``: that program takes about a minute of
XLA-CPU compile at n = 32, w = 4, 4 chunks, which would double this file's
time.  Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_BLS, BN254_G1 as J_BN
from tpu_ec_torch.config import get_config
from tpu_ec_torch.curves import BLS12_381_G1, BN254_G1
from tpu_ec_torch.ops.msm import MultiexpKernel, batch_slab
from tpu_ec_torch.ops.msm_scan import default_window_size_scan

CURVES = {"BN254": (BN254_G1, J_BN), "BLS12_381": (BLS12_381_G1, J_BLS)}


def _batch(curve, pts, ks, C, **kw):
    tspec, _ = CURVES[curve]
    kern = MultiexpKernel(tspec, "cpu", maybe_abort=kw.pop("maybe_abort", None))
    ops = kern.ops
    out = kern.multiple_multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), C, **kw)
    return ops, out


def _check_chunks(curve, pts, ks, C, **kw):
    _, jspec = CURVES[curve]
    ops, out = _batch(curve, pts, ks, C, **kw)
    got = ops.to_affine_ints(ops.to_affine(out))
    n = len(pts) // C
    for c in range(C):
        assert got[c] == oracle.msm(jspec, pts[c * n : (c + 1) * n], ks[c * n : (c + 1) * n]), c
    return got


@pytest.mark.parametrize("method", ["pair", "scan"])
@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_batch_vs_oracle(curve, method):
    """C = 4 x 16 points at w = 4.  Chunk 0 has an identity base and a zero
    scalar; chunk 2's scalars are all zero (its result is the identity);
    chunk 3 repeats chunk 0's scalars on other points, so equal digits in
    two chunks must land in two buckets."""
    _, jspec = CURVES[curve]
    C, n = 4, 16
    pts = oracle.random_points(jspec, C * n, seed=300)
    ks = oracle.random_scalars(jspec, C * n, seed=301)
    pts[3] = None
    ks[5] = 0
    ks[2 * n : 3 * n] = [0] * n
    ks[3 * n : 4 * n] = ks[:n]
    got = _check_chunks(curve, pts, ks, C, window_size=4, method=method)
    assert got[2] is None


@pytest.mark.parametrize("method", ["pair", "scan"])
def test_non_pow2_rows(method):
    """C * n = 3 * 7 = 21 rows: the flat engine pads them to 32 with
    identity rows keyed to the last chunk's digit-0 slot."""
    pts = oracle.random_points(J_BLS, 21, seed=302)
    ks = oracle.random_scalars(J_BLS, 21, seed=303)
    _check_chunks("BLS12_381", pts, ks, 3, window_size=4, method=method)


def test_slabs_match_whole_batch(monkeypatch):
    """A device-memory budget that fits two chunks a slab, over 3 chunks:
    two slabs, the second padded with a copy of chunk 0 and zero scalars
    and trimmed; the abort hook is asked once a slab; the points equal the
    whole batch's (one slab under the CPU's default budget)."""
    pts = oracle.random_points(J_BN, 24, seed=304)
    ks = oracle.random_scalars(J_BN, 24, seed=305)
    assert batch_slab(BN254_G1, "pair", 8, 4, "cpu") >= 3
    ops, whole = _batch("BN254", pts, ks, 3, window_size=4)
    budget = 1 << 16
    while batch_slab(BN254_G1, "pair", 8, 4, "cpu", budget) < 2:
        budget *= 2  # at most doubles the slab, so it stops at 2
    monkeypatch.setattr(get_config(), "msm_hbm_budget_bytes", budget)
    assert batch_slab(BN254_G1, "pair", 8, 4, "cpu") == 2
    asked = []

    def maybe_abort():
        asked.append(1)
        return False

    _, slabs = _batch("BN254", pts, ks, 3, window_size=4, maybe_abort=maybe_abort)
    assert len(asked) == 2
    assert slabs[0].shape == (3, ops.L)
    assert ops.to_affine_ints(ops.to_affine(slabs)) == ops.to_affine_ints(ops.to_affine(whole))


@pytest.mark.parametrize("method", ["auto", "scan"])
def test_single_chunk_equals_multiexp(method):
    """C = 1: the batch (the engine with a chunk axis of one) gives
    multiexp's Jacobian point bit for bit."""
    pts = oracle.random_points(J_BN, 16, seed=306)
    ks = oracle.random_scalars(J_BN, 16, seed=307)
    kern = MultiexpKernel(BN254_G1, "cpu")
    b, s = kern.ops.from_affine_ints(pts), kern.ops.scalars_to_limbs(ks)
    got = kern.multiple_multiexp(b, s, 1, window_size=4, method=method)
    want = kern.multiexp(b, s, window_size=4, method=method)
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_other_methods_run_per_chunk():
    """A method without a batch engine runs one multiexp per chunk."""
    pts = oracle.random_points(J_BN, 16, seed=308)
    ks = oracle.random_scalars(J_BN, 16, seed=309)
    _check_chunks("BN254", pts, ks, 2, window_size=4, method="coz")


def test_uneven_chunks_raise():
    kern = MultiexpKernel(BN254_G1, "cpu")
    b = kern.ops.from_affine_ints(oracle.random_points(J_BN, 5, seed=310))
    with pytest.raises(ValueError, match="evenly"):
        kern.multiple_multiexp(b, kern.ops.scalars_to_limbs([1] * 5), 2)


def test_default_window_scan_matches_tpu_ec_model():
    from tpu_ec.ops.msm_scan import default_window_size_scan as j_default

    for log_n in range(1, 25):
        assert default_window_size_scan(1 << log_n) == j_default(1 << log_n)

