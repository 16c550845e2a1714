"""Co-Z sorted-bucket MSM engine (G1): inversion-free scaled-affine adds.

PyTorch counterpart of ``tpu_ec/ops/msm_coz.py``, run for
``MultiexpKernel.multiexp(method="coz")``.  Per window:

  1. sort (|digit|, index) once and gather the points into bucket order as
     one fused (n, 2L) row matrix, y negated where the digit is negative;
  2. run-halving rounds: adjacent entries of a run pair up (parity within
     the run from ``cummax`` of the run starts), a stable sort of the drop
     flag compacts the survivors, and every pair adds with one co-Z batch
     add (``ops/affine.py``: kernels K7 denom, K1 for the product tree, K6).
     All points of a window share one implicit scale Z, which each round
     multiplies by the tree root r (``zrun``);
  3. the shrinking rounds have static sizes (``_plan_sizes``), then a fixed
     ceil(log2(s_f)) rounds at size s_f finish any residual run, so no round
     reads a count back to the host;
  4. the unique survivors scatter into the 2^(w-1) + 2 bucket slots as
     fused Jacobian rows (x, y, zrun), empty buckets (0, 0, 0), and the
     triangular tail (``ops/msm_scan.py::bucket_tail``) and the Horner
     combine of the pair engine finish.

Where ``tpu_ec`` maps windows one at a time with ``lax.map``, every tensor
here has an explicit leading window axis: the product tree runs along the
row axis of a (W, s, L) tensor, so each window keeps its own root, and
``zrun``, r, r^2 and r^3 are (W, 1, L), which K6 reads by window.
"""

from __future__ import annotations

import math

import torch

from ..curves.point import PointOps
from ..utils.timer import phase
from .affine import coz_add_batch
from .msm import SCALAR_BITS, make_digits
from .msm_pair import SENT, _gather_rows, horner_combine
from .msm_scan import _unfuse, bucket_tail
from .msm_sorted import _plan_sizes


def default_window_size_coz(n: int) -> int:
    """tpu_ec's cost model of the engine: per window ~2n carried rows over
    the rounds plus the B log2(B) Jacobian triangular tail."""
    if n <= 1:
        return 2
    best_w, best_cost = 2, float("inf")
    for w in range(2, 17):
        W = -(-SCALAR_BITS // w)
        B = 1 << (w - 1)
        cost = W * (2.0 * n + 6.0 * B * max(1, w - 1))
        if cost < best_cost:
            best_w, best_cost = w, cost
    return best_w


def _run_parity(key: torch.Tensor):
    """(run_start_flags, even_parity_within_run) of sorted (W, s) keys."""
    W, s = key.shape
    i = torch.arange(s, device=key.device)
    f = torch.cat([torch.ones((W, 1), dtype=torch.bool, device=key.device),
                   key[:, 1:] != key[:, :-1]], dim=1)
    start = torch.cummax(torch.where(f, i, 0), dim=1).values
    return f, ((i - start) & 1) == 0


def _pair_up(key, data, s_out: int):
    """The pairs of one run-halving round: (W, s) sorted keys and (W, s, 2L)
    fused rows -> the survivors' keys (W, s_out), SENT past the survivor
    count, and the pair rows A, B (W, s_out, 2L): A the even entries of
    each run, B the entry after it where that is in the same run, else 0
    (the identity).  Survivors number at most s // 2 + #runs / 2 + 2 <=
    s_out for the planned sizes."""
    W, s = key.shape
    _, par_even = _run_parity(key)
    nxt_same = torch.cat([key[:, 1:] == key[:, :-1],
                          torch.zeros((W, 1), dtype=torch.bool, device=key.device)], dim=1)
    paired = par_even & nxt_same
    # survivors first, in order: a stable sort of the drop flag
    sel = torch.sort((~par_even).to(torch.int32), dim=1, stable=True).indices[:, :s_out]
    m = par_even.sum(dim=1, keepdim=True)
    valid = torch.arange(s_out, device=key.device) < m
    keyn = torch.where(valid, torch.gather(key, 1, sel), SENT)
    A = torch.where(valid.unsqueeze(-1), _gather_rows(data, sel), 0)
    pairedA = torch.gather(paired, 1, sel) & valid
    B = torch.where(pairedA.unsqueeze(-1), _gather_rows(data, (sel + 1).clamp(max=s - 1)), 0)
    return keyn, A, B


def _halving_round_coz(ops: PointOps, key, data, zrun, s_out: int):
    """One co-Z run-halving round over all windows: (W, s) keys, (W, s, 2L)
    fused rows at the scales ``zrun`` (W, 1, L) -> size s_out, scales
    zrun * r."""
    L = ops.L
    keyn, A, B = _pair_up(key, data, s_out)
    (x3, y3), r1 = coz_add_batch(
        ops.spec.base, (A[..., :L], A[..., L:]), (B[..., :L], B[..., L:])
    )
    return keyn, torch.cat([x3, y3], dim=-1), ops.F.mul(zrun, r1)


def _bucket_rows(ops: PointOps, points, scalars: torch.Tensor, w: int):
    """Every window's points in bucket order: the sorted |digit| keys
    (W, n) and the fused rows (W, n, 2L), y negated where the digit is negative."""
    L = ops.L
    num_windows = -(-SCALAR_BITS // w)
    n = scalars.shape[0]
    with phase("msm/digits"):
        digits_t = make_digits(scalars, w, num_windows, True).T.contiguous()  # (W, n)
    key, perm = torch.sort(digits_t.abs(), dim=1, stable=True)
    # one gather per window from [points; negated points]: row perm + n
    # holds -P, taken where the digit is negative
    x, y = points
    table = torch.cat([torch.cat([x, y], dim=1), torch.cat([x, ops.F.neg(y)], dim=1)], dim=0)
    idx = perm + n * torch.gather(digits_t < 0, 1, perm)
    return key, table.index_select(0, idx.reshape(-1)).reshape(num_windows, n, 2 * L)


def msm_coz_buckets(ops: PointOps, points, scalars: torch.Tensor, *, window_size: int):
    """Bucket accumulation: (W, 2^(w-1) + 2, 3L) fused Jacobian buckets
    (slot 0 = digit 0, slot 2^(w-1) + 1 = overflow; both excluded from the
    reduction).  ``points`` are affine (x, y) of (n, L); ``scalars`` are
    (n, Ls + 1) plain limbs, zero-padded by one limb."""
    if ops.spec.ext != 1:
        raise NotImplementedError("the co-Z engine is G1-only, as tpu_ec's is (tpu_ec/ops/msm_coz.py:134); "
                                  "G2 runs on the pair engine (method 'pair' or 'auto')")
    F = ops.F
    L = ops.L
    w = window_size
    num_windows = -(-SCALAR_BITS // w)
    half = 1 << (w - 1)
    nbuckets = half + 2
    n = scalars.shape[0]

    key, data = _bucket_rows(ops, points, scalars, w)
    zrun = F.one.expand(num_windows, 1, L).contiguous()  # Montgomery one

    for s_out in _plan_sizes(n, half):
        key, data, zrun = _halving_round_coz(ops, key, data, zrun, s_out)
    s_f = key.shape[1]
    for _ in range(max(1, math.ceil(math.log2(s_f))) if s_f > 1 else 0):
        key, data, zrun = _halving_round_coz(ops, key, data, zrun, s_f)

    # every run has length 1: scatter into the buckets, sentinels into the
    # overflow slot (excluded from the sum, so which one lands there is moot)
    slot = key.clamp(max=nbuckets - 1).long().unsqueeze(-1).expand(num_windows, s_f, 2 * L)
    buckets = data.new_zeros((num_windows, nbuckets, 3 * L))
    buckets[..., : 2 * L].scatter_(1, slot, data)
    ident = F.is_zero(buckets[..., :L]) & F.is_zero(buckets[..., L : 2 * L])
    buckets[..., 2 * L :] = torch.where(ident.unsqueeze(-1), 0, zrun.expand(num_windows, nbuckets, L))
    return buckets


def msm_coz(ops: PointOps, points, scalars: torch.Tensor, *, window_size: int):
    """One full MSM -> Jacobian point with batch shape (1,)."""
    buckets = msm_coz_buckets(ops, points, scalars, window_size=window_size)
    tri = bucket_tail(ops, buckets, 1 << (window_size - 1))
    return horner_combine(ops, _unfuse(tri, ops.L, 3), window_size)
