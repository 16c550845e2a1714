"""Masked segmented-scan MSM engine, and the masked scans of the bucket tail.

PyTorch counterpart of ``tpu_ec/ops/msm_scan.py``.  Per window (all windows,
and for a batch all chunks, in one tensor):

  1. sort (|digit|, index), gather the points into bucket order once, then a
     masked Hillis-Steele *segmented* inclusive scan along the sorted axis:
     log2(n) rounds, each one K3 ``add`` of every row with the row h before
     it, kept (``keep``) where the keys differ; each run's last row holds its
     bucket sum and scatters into the (half + 2)-slot bucket array;
  2. triangular tail sum_k k * b_k: inclusive prefix scan of the reversed
     bucket row, summed by a halving tree (``masked_prefix_scan_add``,
     ``masked_tree_sum``; every engine's tail is ``bucket_tail``);
  3. the Horner window combine (kernel K3, one tile of lanes a chunk).

Every shifted round here and in the pair engine's finish is
:func:`_shifted_add`: the row h before is read through an offset view of
the same contiguous block, never from a shifted copy of it.

It does ~log2(n) times the pair engine's adds; ``tpu_ec`` built it for its
short XLA compile, and its "auto" runs G2 here; the port's "auto" runs the
pair engine on both groups, and ``method="scan"`` reaches this one.  A
coordinate is ``ops.width`` = ext * L half-limbs (Fq2's c0 then c1 on G2),
so fused blocks carry 3 * ext * L columns, in tpu_ec's column order; K3
runs its Fq2 instances on G2.
"""

from __future__ import annotations

import math

import torch

from ..curves.point import PointOps
from ..kernels.point import horner
from ..utils.timer import phase
from .msm import SCALAR_BITS, make_digits


def _fuse(P):
    """Coordinates (..., L) each -> one fused (..., k L) row block (L: a
    coordinate's half-limbs, ``PointOps.width``)."""
    return torch.cat(P, dim=-1)


def _unfuse(D, L: int, k: int):
    """Fused (..., k L) block -> its k coordinates (views)."""
    return tuple(D[..., i * L : (i + 1) * L] for i in range(k))


def _fused_add(ops: PointOps, a, b, L: int, *, keep=None):
    """K3 add on fused (..., 3L) blocks into a new fused block:
    where(keep, a, a + b)."""
    out = a.new_empty(a.shape)
    ops.add(_unfuse(a, L, 3), _unfuse(b, L, 3), keep=keep, out=out)
    return out


def scalar_mul_small(ops: PointOps, P, k: int, nbits: int):
    """[k] P for a host scalar 0 <= k < 2^nbits over a Jacobian batch:
    tpu_ec's MSB-first double-and-add over nbits from the identity, in one
    launch of K3's chain entry (``PointOps.scalar_mul``: its leading zero
    bits double the all-zero identity, which stays all zero, so the bits
    are tpu_ec's)."""
    if not 0 <= k < 1 << nbits:
        raise ValueError(f"scalar_mul_small: k = {k} is not below 2^{nbits}")
    return ops.scalar_mul(P, ops.fr.constant(k, mont=False))


def sorted_affine_rows(ops: PointOps, points, digits_t: torch.Tensor):
    """Signed digits (..., W, n) and affine points (x, y) of (..., n, L) ->
    (key, rows): the |digit|s sorted stably along n, (B W, n), and the fused
    (B W, n, 2L) affine rows in that order, a negative digit's point
    negated (B: the leading axes' size, each chunk's digits paired with its
    own points; L = ``ops.width``).  The sorted engine starts from these
    rows; the segmented scan lifts them (:func:`sorted_rows`)."""
    L = ops.width
    lead = digits_t.shape[:-2]
    W, n = digits_t.shape[-2:]
    B = math.prod(lead)
    dig = digits_t.reshape(B, W, n)
    x, y = (c.reshape(B * n, L) for c in points)

    key, perm = torch.sort(dig.abs(), dim=-1, stable=True)  # (B, W, n)
    # one gather from [points; negated points]: row perm + chunk offset,
    # + B * n where the digit is negative
    table = torch.cat([torch.cat([x, y], dim=1), torch.cat([x, ops.F.neg(y)], dim=1)], dim=0)
    base = (torch.arange(B, device=dig.device) * n).view(B, 1, 1)
    idx = perm + base + B * n * torch.gather(dig < 0, 2, perm)
    rows = table.index_select(0, idx.reshape(-1)).reshape(B * W, n, 2 * L)
    return key.reshape(B * W, n), rows


def sorted_rows(ops: PointOps, points, digits_t: torch.Tensor):
    """The segmented scan's input: :func:`sorted_affine_rows` with the rows
    lifted to fused (B W, n, 3L) Jacobian rows ((0, 0) gets z = 0)."""
    L = ops.width
    key, rows = sorted_affine_rows(ops, points, digits_t)
    return key, torch.cat(ops.to_jacobian((rows[..., :L], rows[..., L:])), dim=-1)


def scan_keep(key: torch.Tensor, h: int) -> torch.Tensor:
    """``keep`` of the scan's round with stride h over (..., n) keys: set
    where a row's key differs from the key h rows before it, and at every
    row below h (there the row stays as it is)."""
    keep = torch.ones_like(key, dtype=torch.bool)
    keep[..., h:] = key[..., h:] != key[..., :-h]
    return keep


def _shifted_add(ops: PointOps, data: torch.Tensor, h: int, keep: torch.Tensor, L: int):
    """One Hillis-Steele round of stride h along axis -2 of a fused
    (..., s, 3L) block, into a new block: where(keep, row, row + the row h
    before it).  ``keep`` (bool, (..., s)) must be set at every row below h
    of its segment (window, chunk).

    The partner is flat row i - h of the same block, an offset view: no
    shifted copy is made.  For a row below h that row lies in the previous
    segment, and ``keep`` discards it.  The first h flat rows are copied,
    the rest are one K3 launch; the views overlap, but only as inputs."""
    C = data.shape[-1]
    flat = data.reshape(-1, C)
    out = torch.empty_like(flat)
    out[:h] = flat[:h]
    ops.add(_unfuse(flat[h:], L, 3), _unfuse(flat[:-h], L, 3), keep=keep.reshape(-1)[h:], out=out[h:])
    return out.view(data.shape)


def scan_buckets(ops: PointOps, points, digits_t: torch.Tensor, *, half: int):
    """Signed digits (..., W, n) and affine points (x, y) of (..., n, L) ->
    fused (..., W, half + 2, 3L) Jacobian buckets (slot 0 = digit-0 junk,
    slot half + 1 = scatter junk; both excluded downstream), L =
    ``ops.width``.  Leading axes (a batch of chunks) pair each chunk's
    digits with its own points."""
    lead, (W, n) = digits_t.shape[:-2], digits_t.shape[-2:]
    with phase("msm/scan/rows"):
        key, data = sorted_rows(ops, points, digits_t)
    for r in range(max(0, (n - 1).bit_length())):
        with phase("msm/scan/round"):
            data = _shifted_add(ops, data, 1 << r, scan_keep(key, 1 << r), ops.width)

    with phase("msm/scan/scatter"):
        nxt = torch.cat([key[:, 1:], torch.full_like(key[:, :1], -1)], dim=1)
        slot = torch.where(key != nxt, key.clamp(max=half + 1), half + 1).long()
        out = data.new_zeros((key.shape[0], half + 2, data.shape[-1]))
        out.scatter_(1, slot.unsqueeze(-1).expand(data.shape), data)
    return out.reshape(*lead, W, half + 2, data.shape[-1])


def masked_prefix_scan_add(ops: PointOps, x: torch.Tensor, L: int, width: int):
    """Inclusive prefix point-scan along axis -2 of a fused (..., width, 3L)
    block (any leading axes): round r adds to each row the row 2^r before
    it, rows below 2^r kept."""
    iota = torch.arange(width, device=x.device)
    for r in range(max(0, (width - 1).bit_length())):
        h = 1 << r
        x = _shifted_add(ops, x, h, (iota < h).expand(x.shape[:-1]), L)
    return x


def masked_tree_sum(ops: PointOps, x: torch.Tensor, L: int, width: int):
    """Sum along axis -2 of a fused (..., width, 3L) block (width a power
    of two): a halving tree, row i + width/2^(r+1) added into row i.
    Returns (..., 3L): row 0 of tpu_ec's constant-shape masked tree, whose
    rows past the half only carry copies."""
    g = width
    while g > 1:
        x = _fused_add(ops, x[..., : g // 2, :], x[..., g // 2 : g, :], L)
        g //= 2
    return x[..., 0, :]


def bucket_tail(ops: PointOps, buckets: torch.Tensor, half: int):
    """sum_{k=1..half} k * bucket[k] of fused (..., half + 2, 3L) buckets
    (slot 0 and slot half + 1 excluded): the prefix scan of the reversed
    row summed by the tree (sum of reversed prefixes = sum_k k b_k).
    Returns (..., 3L)."""
    with phase("msm/tail"):
        rev = buckets[..., 1 : half + 1, :].flip(-2)
        return masked_tree_sum(ops, masked_prefix_scan_add(ops, rev, ops.width, half), ops.width, half)


def msm_scan(ops: PointOps, points, scalars: torch.Tensor, *, window_size: int):
    """MSMs on the scan engine: affine (x, y) of (n, L) (L = ``ops.width``)
    and (n, Ls + 1) plain zero-padded scalar limbs -> one Jacobian point,
    batch (1,); with a leading chunk axis, (C, n, L) and (C, n, Ls + 1) ->
    batch (C,)."""
    L = ops.width
    w = window_size
    num_windows = -(-SCALAR_BITS // w)
    half = 1 << (w - 1)
    batched = scalars.dim() == 3
    if not batched:
        points, scalars = tuple(c.unsqueeze(0) for c in points), scalars.unsqueeze(0)
    C, n = scalars.shape[:2]
    with phase("msm/digits"):
        digits = make_digits(scalars.reshape(C * n, -1), w, num_windows, True)  # (C n, W)
        digits_t = digits.reshape(C, n, num_windows).transpose(1, 2)  # (C, W, n)
    buckets = scan_buckets(ops, points, digits_t, half=half)  # (C, W, half + 2, 3L)
    tri = bucket_tail(ops, buckets, half).transpose(0, 1)  # (W, C, 3L)
    with phase("msm/horner"):
        return horner(ops.spec.base, _unfuse(tri, L, 3), w, ext=ops.spec.ext)


def default_window_size_scan(n: int) -> int:
    """tpu_ec's cost model of the engine: ~log2(n) masked adds per point
    per window plus a ~2 * half * log2(half) tail, W = ceil(256 / w)."""
    if n <= 1:
        return 2
    best_w, best_cost = 2, float("inf")
    logn = max(1, (n - 1).bit_length())
    for w in range(2, 17):
        W = -(-SCALAR_BITS // w)
        B = 1 << (w - 1)
        cost = W * (n * logn + 2.0 * B * max(1, B.bit_length()))
        if cost < best_cost:
            best_w, best_cost = w, cost
    return best_w
