"""Pair-halving MSM engine (G1 and G2), for one MSM or a flat batch of them.

PyTorch counterpart of ``tpu_ec/ops/msm_pair.py`` and of the flat engine of
``tpu_ec/ops/msm_batch.py``.  Per window:

  1. sort the bucket keys and gather the points into bucket order once, as
     a fused (n, 2L) row matrix, negating y where the digit is negative
     (L = ``ops.width``, a coordinate's half-limbs: ext times Fq's, so a
     G2 row carries Fq2's c0 then c1 per coordinate and K3 runs its Fq2
     instances; ``tpu_ec``'s engine takes G1 only,
     ``tpu_ec/ops/msm_pair.py:174``).
     The key is |digit|; for a batch of C chunks (the AMT workload: C
     independent n-point MSMs, ``ag-build/cl/multiexp.cl:217-263`` runs
     them in one launch) it is chunk * (half + 1) + |digit| over all C * n
     rows, so equal digits of different chunks never merge;
  2. pair rounds: view (s, C) as (s/2, 2, C) and pair (2i, 2i+1).  Equal
     keys merge with one batched point add (kernel K3, which writes the
     round's fused rows itself); a boundary pair keeps its left entry and
     spills its right entry into a side buffer of at most C * (half + 1) + 1
     rows (#boundary pairs < #live runs), packed by a monotone masked
     gather.  Every round halves the width;
  3. finish: all spills and the last survivor, stably re-sorted, folded by
     a strided segmented scan that keeps each run's last entry (its rounds
     read the row sh before through an offset view of the same block,
     ``ops/msm_scan.py::_shifted_add``);
  4. the unique survivors scatter into a (C, half + 2)-slot bucket array,
     then the triangular tails (``ops/msm_scan.py::bucket_tail``) and the
     Horner window combine, one K3 tile of lanes a chunk.

Where ``tpu_ec`` maps windows with ``vmap``/``lax.map``, every tensor here
has an explicit leading window axis, so each round is one batched point
op over all windows.  Sorts are ``torch.sort(stable=True)``
(``jax.lax.sort_key_val`` is stable), gathers ``index_select``/``gather``.
"""

from __future__ import annotations

import math

import torch

from ..curves.point import PointOps
from ..kernels.point import horner
from ..utils.timer import phase
from .msm import SCALAR_BITS, make_digits
from .msm_scan import _fuse, _shifted_add, _unfuse, bucket_tail, scan_keep

SENT = torch.iinfo(torch.int32).max


def default_window_size_pair(n: int) -> int:
    """Analytic cost model of the engine: per window a sort and a gather of
    n rows, ~n adds, and a bucket tail of ~2*B*log2(B) add lanes; W =
    ceil(256/w) windows.  The weights are tpu_ec's; they shape the choice
    only through their ratios."""
    if n <= 1:
        return 2
    best_w, best_cost = 2, float("inf")
    for w in range(2, 17):
        W = -(-SCALAR_BITS // w)
        B = 1 << (w - 1)
        cost = W * (n * (6.6 + 56 + 70) + 90.0 * B * max(1, int(math.log2(B)) + 1))
        if cost < best_cost:
            best_w, best_cost = w, cost
    return best_w


def _finish_rounds(rounds: int) -> int:
    """The finish's scan rounds after ``rounds`` pair rounds, tpu_ec's
    count (tpu_ec/ops/msm_pair.py:238): a key's rows among the last
    survivor and the spills are fewer than rounds + 2."""
    return max(1, math.ceil(math.log2(rounds + 2)))


def pair_steps(n: int, w: int) -> dict:
    """K3 launches of ``msm_pair`` on n rows (C n for a batch) at window w:
    one a pair round (log2 of n rounded up to a power of two), the
    finish's scan rounds, the prefix scan and the tree of the tail, one
    Horner."""
    rounds = max(1, (n - 1).bit_length())
    return {"rounds": rounds, "finish": _finish_rounds(rounds), "tail": 2 * (w - 1), "horner": 1}


def _gather_rows(data: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """data (W, s, C), idx (W, c) -> (W, c, C): rows of each window."""
    return torch.gather(data, 1, idx.unsqueeze(-1).expand(idx.shape + (data.shape[-1],)))


def _masked_monotone_pack(keys, data, mask, cap: int):
    """Per window, pack the rows of data (W, s, C) where mask is set into a
    (W, cap, C) buffer, keeping order.  Rows beyond cap are dropped: callers
    size cap to the proven bound.  Empty slots hold (SENT, 0)."""
    s = keys.shape[1]
    iota = torch.arange(s, device=keys.device, dtype=torch.int64)
    slot = torch.where(mask, iota, s)
    order = torch.sort(slot, dim=1).values[:, :cap]
    valid = order < s
    safe = order.clamp(max=s - 1)
    pk = torch.where(valid, torch.gather(keys, 1, safe), SENT)
    pd = torch.where(valid.unsqueeze(-1), _gather_rows(data, safe), 0)
    return pk, pd


def _pair_round(ops: PointOps, key, data, *, affine: bool, spill_cap: int):
    """One halving round: (W, s) keys + (W, s, C) fused rows -> (W, s/2)
    + spill.  Equal-key pairs merge (one batched add); boundary pairs keep
    left and spill right.  The new rows are always Jacobian (3L columns, L
    = ``ops.width``): the add writes them, P where the keys differ."""
    L = ops.width
    W, s = key.shape
    kp = key.reshape(W, s // 2, 2)
    ke, ko = kp[..., 0], kp[..., 1]
    dp = data.reshape(W, s // 2, 2, data.shape[-1])
    A, B = dp[:, :, 0], dp[:, :, 1]
    differ = ke != ko
    out = data.new_empty((W, s // 2, 3 * L))
    if affine:
        ops.add_mixed(_unfuse(A, L, 2), _unfuse(B, L, 2), keep=differ, out=out)
    else:
        ops.add(_unfuse(A, L, 3), _unfuse(B, L, 3), keep=differ, out=out)
    sk, sd = _masked_monotone_pack(ko, B, differ & (ko != SENT), spill_cap)
    return ke, out, sk, sd


def _seg_scan_finish(ops: PointOps, key, data, max_run_log: int):
    """Strided segmented scan: after sorting, residual runs are short
    (<= 2^max_run_log); log-depth shifted adds fold each run into its LAST
    entry (Hillis-Steele induction).  Returns (key, data) with non-last
    entries keyed SENT."""
    for r in range(max_run_log):
        sh = 1 << r
        data = _shifted_add(ops, data, sh, scan_keep(key, sh) | (key == SENT), ops.width)
    nxt = torch.cat([key[:, 1:], torch.full_like(key[:, :1], SENT)], dim=1)
    is_last = (key != nxt) & (key != SENT)
    return torch.where(is_last, key, SENT), data


def _bucket_rows(ops: PointOps, points, scalars: torch.Tensor, w: int):
    """Step 1: per window, the sorted bucket keys (W, rows) and the points
    in bucket order as fused (W, rows, 2L) affine rows, y negated where the
    digit is negative (L = ``ops.width``).  ``points`` (x, y) are (n, L),
    or (C, n, L) with
    ``scalars`` (C, n, Ls + 1) for a batch, whose keys carry the chunk id;
    rows = C * n rounded up to a power of two, the padding rows (identities,
    digit 0) keyed to chunk C - 1's slot 0, which the tail never reads."""
    F = ops.F
    L = ops.width
    num_windows = -(-SCALAR_BITS // w)
    half = 1 << (w - 1)
    C = scalars.shape[0] if scalars.dim() == 3 else 1
    n = scalars.shape[-2]
    rows0 = C * n
    rows = 1 << max(1, (rows0 - 1).bit_length())
    if C * (half + 1) >= SENT:
        raise ValueError(f"batch MSM: {C} chunks x {half + 1} buckets overflow the int32 keys")
    with phase("msm/digits"):
        digits = make_digits(scalars.reshape(rows0, -1), w, num_windows, True)  # (C n, W) int32
        if rows != rows0:
            digits = torch.cat([digits, digits.new_zeros((rows - rows0, num_windows))], dim=0)
        digits_t = digits.T.contiguous()  # (W, rows)
        del digits
    with phase("msm/pair/rows"):
        fused = _fuse(tuple(c.reshape(rows0, L) for c in points))  # (C n, 2L)
        if rows != rows0:
            fused = torch.cat([fused, fused.new_zeros((rows - rows0, 2 * L))], dim=0)
        chunk_id = (torch.arange(rows, dtype=torch.int32, device=scalars.device) // n).clamp(max=C - 1)
        key_s, perm = torch.sort(chunk_id * (half + 1) + digits_t.abs(), dim=1, stable=True)
        # one gather per window from [points; negated points]: row perm + rows
        # holds -P, taken where the digit is negative
        table = torch.cat([fused, _fuse((fused[:, :L], F.neg(fused[:, L:])))], dim=0)
        idx = perm + rows * torch.gather(digits_t < 0, 1, perm)
        del perm, digits_t
        return key_s, table.index_select(0, idx.reshape(-1)).reshape(num_windows, rows, 2 * L)


def msm_pair_buckets(ops: PointOps, points, scalars: torch.Tensor, *, window_size: int):
    """Bucket accumulation: returns (W, half + 2, 3L) fused Jacobian buckets
    (slot 0 = digit-0 dummy, slot half + 1 = overflow; both excluded from
    the reduction), or (W, C, half + 2, 3L) for a batch (L =
    ``ops.width``).  ``points`` are affine (x, y) of (n, L) ((0, 0) =
    identity), or (C, n, L); ``scalars`` are (n, Ls + 1), or (C, n, Ls +
    1), plain limbs, zero-padded by one limb."""
    L = ops.width
    w = window_size
    num_windows = -(-SCALAR_BITS // w)
    half = 1 << (w - 1)
    nbuckets = half + 2
    C = scalars.shape[0] if scalars.dim() == 3 else 1
    k, d = _bucket_rows(ops, points, scalars, w)
    rounds = int(math.log2(k.shape[1]))
    spill_cap = C * (half + 1) + 1  # spills per round < #live runs <= C * (half + 1)
    spills = []
    for r in range(rounds):
        with phase("msm/pair/round"):
            k, d, sk, sd = _pair_round(
                ops, k, d, affine=(r == 0), spill_cap=min(k.shape[1] // 2, spill_cap)
            )
            if r == 0:
                # round-1 spills are affine rows: lift to Jacobian, keeping the
                # identity encoding (z = 0) in empty slots
                sd = _fuse(ops.to_jacobian(_unfuse(sd, L, 2)))
                sd = torch.where((sk != SENT).unsqueeze(-1), sd, 0)
            spills.append((sk, sd))

    # survivors: the one remaining row + all spills; keys repeat at most
    # (#rounds + 1) times across spill generations
    with phase("msm/pair/survivors"):
        fk = torch.cat([k] + [s[0] for s in spills], dim=1)
        fd = torch.cat([d] + [s[1] for s in spills], dim=1)
        del k, d, spills
        fk, order = torch.sort(fk, dim=1, stable=True)
        fd = _gather_rows(fd, order)
        fk, fd = _seg_scan_finish(ops, fk, fd, _finish_rounds(rounds))

    # unique survivors -> pack -> scatter into the (C, half + 2) grid; an
    # empty slot goes to chunk 0's overflow slot
    with phase("msm/pair/scatter"):
        pk, pd = _masked_monotone_pack(fk, fd, fk != SENT, spill_cap)
        del fk, fd
        live = pk != SENT
        chunk = torch.where(live, pk // (half + 1), 0)
        slot = torch.where(live, pk % (half + 1), nbuckets - 1)
        buckets = pd.new_zeros((num_windows, C * nbuckets, 3 * L))
        buckets.scatter_(1, (chunk * nbuckets + slot).long().unsqueeze(-1).expand(pd.shape), pd)
    return buckets.reshape(num_windows, C, nbuckets, 3 * L) if scalars.dim() == 3 else buckets


def horner_combine(ops: PointOps, partials, w: int):
    """Per-window sums (W, L), or (W, C, L) for a batch, coordinates -> the
    final point (1, L), or (C, L), high to low: res = 2^w * res + S_j
    (multiexp.rs:221-235), in one K3 launch (Fq2's on G2), one tile of
    lanes a chunk."""
    with phase("msm/horner"):
        return horner(ops.spec.base, partials, w, ext=ops.spec.ext)


def msm_pair(ops: PointOps, points, scalars: torch.Tensor, *, window_size: int):
    """One full MSM -> Jacobian point with batch shape (1,); for a batch
    ((C, n, L) points, (C, n, Ls + 1) scalars), C MSMs -> batch (C,)."""
    w = window_size
    tri = bucket_tail(ops, msm_pair_buckets(ops, points, scalars, window_size=w), 1 << (w - 1))
    return horner_combine(ops, _unfuse(tri, ops.width, 3), w)
