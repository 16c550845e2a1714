"""The MSM engines' shifted adds (``ops/msm_scan.py::_shifted_add``).

Every Hillis-Steele round reads its partner, the row h before, as an
offset view of the same block.  Held bit-equal to the formulation with a
materialised shifted copy (``torch.roll`` / ``torch.cat``, written out here
as the reference) in the scan engine's rounds (BN254 G1 and BLS12-381 G2,
one MSM and a chunk axis, runs of equal keys over window and chunk
boundaries), the bucket tail's prefix scan (0, 1 and 2 leading axes) and
the pair engine's finish (SENT rows, runs at the segment starts).  Under
torch.profiler the engines record no ``aten::roll``, and their rounds no
copy of the block.  Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from torch.profiler import ProfilerActivity, profile

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G2 as J_BLS2, BN254_G1 as J_BN
from tpu_ec_torch import curves
from tpu_ec_torch.curves import PointOps
from tpu_ec_torch.kernels import point as kpoint
from tpu_ec_torch.ops.msm_pair import SENT, _seg_scan_finish, msm_pair
from tpu_ec_torch.ops.msm_scan import (_fused_add, bucket_tail, masked_prefix_scan_add, msm_scan, scan_buckets,
                                       sorted_rows)
from tpu_ec_torch.utils import timer

CURVES = {"BN254_G1": (curves.BN254_G1, J_BN), "BLS12_381_G2": (curves.BLS12_381_G2, J_BLS2)}
HALF = 4  # the scan's buckets: |digit| <= 4


def _affine(name, ops, shape, seed):
    """Affine (x, y) of ``shape`` + (L,): random points, every fifth one the
    identity (0, 0)."""
    n = 1
    for d in shape:
        n *= d
    pts = oracle.random_points(CURVES[name][1], n, seed=seed)
    pts[::5] = [None] * len(pts[::5])
    return tuple(c.reshape(*shape, ops.width) for c in ops.from_affine_ints(pts))


def _jacobian(name, ops, shape, seed):
    """Fused (shape, 3L) Jacobian rows with z != 1, the identity among them."""
    return torch.cat(ops.double(ops.to_jacobian(_affine(name, ops, shape, seed))), dim=-1)


def _scan_buckets_rolled(ops, points, digits_t, half):
    """``scan_buckets`` with each round's partner a rolled copy of the block
    (the reference), as (B W, half + 2, 3L) buckets."""
    key, data = sorted_rows(ops, points, digits_t)
    iota = torch.arange(key.shape[-1])
    for r in range(max(0, (key.shape[-1] - 1).bit_length())):
        h = 1 << r
        same = (key == torch.roll(key, h, dims=1)) & (iota >= h)
        data = _fused_add(ops, data, torch.roll(data, h, dims=1), ops.width, keep=~same)
    nxt = torch.cat([key[:, 1:], torch.full_like(key[:, :1], -1)], dim=1)
    slot = torch.where(key != nxt, key.clamp(max=half + 1), half + 1).long()
    out = data.new_zeros((key.shape[0], half + 2, data.shape[-1]))
    out.scatter_(1, slot.unsqueeze(-1).expand(data.shape), data)
    return out


@pytest.mark.parametrize("name", list(CURVES))
@pytest.mark.parametrize("lead", [(), (2,)], ids=["single", "chunks"])
@pytest.mark.parametrize("n", [1, 2, 6, 8])
def test_scan_buckets_offset_views_equal_rolled(name, lead, n):
    """3 windows: window 0 all digit 3 (one run reaching both of its
    boundaries), window 1 random, window 2 all -3 (a run that meets the
    next chunk's window 0, the same key)."""
    ops = PointOps(CURVES[name][0], "cpu")
    points = _affine(name, ops, (*lead, n), seed=500 + n)
    g = torch.Generator().manual_seed(510 + n)
    digits = torch.randint(-HALF, HALF + 1, (*lead, 3, n), generator=g, dtype=torch.int32)
    digits[..., 0, :] = 3
    digits[..., 2, :] = -3
    got = scan_buckets(ops, points, digits, half=HALF)
    assert got.shape == (*lead, 3, HALF + 2, 3 * ops.width)
    assert torch.equal(got.reshape(-1, HALF + 2, 3 * ops.width), _scan_buckets_rolled(ops, points, digits, HALF))


@pytest.mark.parametrize("name", list(CURVES))
@pytest.mark.parametrize("lead", [(), (2,), (2, 3)], ids=["0-axes", "1-axis", "2-axes"])
@pytest.mark.parametrize("width", [5, 8])
def test_prefix_scan_offset_views_equal_rolled(name, lead, width):
    ops = PointOps(CURVES[name][0], "cpu")
    L = ops.width
    x = _jacobian(name, ops, (*lead, width), seed=520 + width)
    iota = torch.arange(width)
    want = x
    for r in range((width - 1).bit_length()):
        h = 1 << r
        want = _fused_add(ops, want, torch.roll(want, h, dims=-2), L, keep=(iota < h).expand(x.shape[:-1]))
    assert torch.equal(masked_prefix_scan_add(ops, x, L, width), want)


S = SENT
# (W, s) sorted keys: runs at every window's start, SENT tails, window 1's
# first run the key of window 0's last live run, window 2's first run the
# key of window 1's last row
FINISH_KEYS = [[1, 1, 1, 2, 5, 5, 5, 5, S, S, S, S],
               [5, 5, 5, 6, 6, 7, 9, 9, 9, 9, 9, 9],
               [9, 9, 9, 9, 10, 11, 11, 11, 11, 11, S, S]]


def _finish_cat(ops, key, data, max_run_log):
    """The finish with each round's partner and its key built by
    ``torch.cat`` of SENT / zero padding and the shifted block (the
    reference)."""
    for r in range(max_run_log):
        sh = 1 << r
        k_sh = torch.cat([torch.full_like(key[:, :sh], SENT), key[:, :-sh]], dim=1)
        d_sh = torch.cat([torch.zeros_like(data[:, :sh]), data[:, :-sh]], dim=1)
        data = _fused_add(ops, data, d_sh, ops.L, keep=(key != k_sh) | (key == SENT))
    nxt = torch.cat([key[:, 1:], torch.full_like(key[:, :1], SENT)], dim=1)
    return torch.where((key != nxt) & (key != SENT), key, SENT), data


@pytest.mark.parametrize("s,max_run_log", [(12, 1), (12, 2), (12, 3), (12, 4), (4, 3)])
def test_finish_offset_views_equal_cat(s, max_run_log):
    """s 4 with 3 rounds: the last round's stride is the segment's length."""
    ops = PointOps(curves.BN254_G1, "cpu")
    key = torch.tensor(FINISH_KEYS, dtype=torch.int32)[:, :s]
    data = _jacobian("BN254_G1", ops, (3, s), seed=530 + s)  # SENT rows too hold points
    got_k, got_d = _seg_scan_finish(ops, key, data, max_run_log)
    want_k, want_d = _finish_cat(ops, key, data, max_run_log)
    assert torch.equal(got_k, want_k) and torch.equal(got_d, want_d)


# -- under the profiler: no roll, and no copy of the block in a round ---------


@pytest.fixture
def stand_ins(monkeypatch):
    """K3's plain versions as zeros of their outputs' shapes: what the
    profiler records around them depends on the shapes alone."""
    zeros = lambda coords: tuple(torch.zeros_like(coords[0]) for _ in range(3))
    monkeypatch.setattr(kpoint, "point_op_plain", lambda spec, op, coords, keep=None, ext=1: zeros(coords))
    monkeypatch.setattr(kpoint, "horner_plain",
                        lambda spec, partials, w, ext=1: zeros([c[0] for c in kpoint._chunk_axis(partials)]))


def _under(e, span):
    p = e.cpu_parent
    while p is not None:
        if p.name == timer.PREFIX + span:
            return True
        p = p.cpu_parent
    return False


def _profiled(call):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    return prof.events()


N = 16


def _scalars(n):
    s = torch.zeros((n, 17), dtype=torch.int64)
    s[:, 0] = torch.arange(1, n + 1) * 4099 % 65536
    s[:, 3] = torch.arange(n) * 31 + 7
    return s


@pytest.mark.parametrize("engine", ["scan_g1", "scan_g2", "pair"])
def test_engines_record_no_roll_and_rounds_no_cat(engine, stand_ins):
    """msm_scan (its rounds and its tail) and msm_pair (its tail): no
    ``aten::roll`` anywhere, no ``aten::cat`` inside a ``msm/scan/round``
    or ``msm/tail`` span; one round span a scan round."""
    spec = curves.BN254_G2 if engine == "scan_g2" else curves.BN254_G1
    ops = PointOps(spec, "cpu")
    x, y = ops.generator_affine
    points = (x.expand(N, -1).contiguous(), y.expand(N, -1).contiguous())
    run = msm_pair if engine == "pair" else msm_scan
    events = _profiled(lambda: run(ops, points, _scalars(N), window_size=4))
    names = [e.name for e in events]
    assert "aten::roll" not in names
    rounds = sum(1 for e in events if e.name == timer.PREFIX + "msm/scan/round")
    assert rounds == (0 if engine == "pair" else (N - 1).bit_length())
    assert names.count(timer.PREFIX + "msm/tail") == 1
    for e in events:
        if e.name == "aten::cat":
            assert not _under(e, "msm/scan/round") and not _under(e, "msm/tail")


def test_tail_and_finish_record_no_roll_nor_block_cat(stand_ins):
    """bucket_tail on (2, 3, HALF + 2, 3L) buckets: no roll, no cat; the
    finish over 3 rounds: one ``aten::cat``, the keys' shift after its
    rounds, and no roll."""
    ops = PointOps(curves.BN254_G1, "cpu")
    buckets = torch.ones((2, 3, HALF + 2, 3 * ops.L), dtype=torch.int32)
    names = [e.name for e in _profiled(lambda: bucket_tail(ops, buckets, HALF))]
    assert "aten::roll" not in names and "aten::cat" not in names
    key = torch.tensor(FINISH_KEYS, dtype=torch.int32)
    data = torch.ones((3, 12, 3 * ops.L), dtype=torch.int32)
    names = [e.name for e in _profiled(lambda: _seg_scan_finish(ops, key, data, 3))]
    assert "aten::roll" not in names and names.count("aten::cat") == 1
