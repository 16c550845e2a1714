"""Shared parts of the sorted-bucket MSM engines: the static round sizes and
the triangular weighted bucket sum.

PyTorch counterpart of ``tpu_ec/ops/msm_sorted.py::_plan_sizes``,
``_hs_prefix_scan`` and ``_triangular_sum`` (the sorted engine itself is not
ported).  Where
``tpu_ec`` maps these over windows with ``vmap``, here every tensor carries
an explicit leading window axis: point coordinates are (W, S, L).
"""

from __future__ import annotations

import math

import torch

from ..curves.point import PointOps


def _plan_sizes(n: int, half: int) -> list[int]:
    """Static compaction sizes for the shrinking halving rounds: shrink while
    the geometric term dominates the ~(half + 6) fixed point, then hand off
    to the constant-size rounds."""
    sizes = []
    s = n
    floor = int(1.25 * (half + 6)) + 8
    while s > floor:
        nxt = min(s, s // 2 + half // 2 + 3)
        if nxt >= s:
            break
        s = nxt
        sizes.append(s)
    return sizes


def _hs_prefix_scan(ops: PointOps, v, length: int):
    """Inclusive Hillis-Steele prefix scan with point add along axis 1 of
    (W, length, L) coordinates: ceil(log2(length)) batched adds."""
    iota = torch.arange(length, device=v[0].device)
    ident = ops.identity_jacobian(v[0].shape[:-1])
    acc = v
    for j in range(math.ceil(math.log2(length)) if length > 1 else 0):
        d = 1 << j
        rolled = tuple(torch.roll(c, d, dims=1) for c in acc)
        nb = ops.select((iota >= d).expand(v[0].shape[:-1]), rolled, ident)
        acc = ops.add(acc, nb)
    return acc


def _triangular_sum(ops: PointOps, buckets, half: int):
    """S = sum_{k=1..half} k * bucket[k] per window (multiexp.cl:121-131):
    suffix scan (suffix[k] = sum_{j>=k} b_j, so S = sum_k suffix[k]) then a
    tree sum.  ``buckets`` are (W, half + 2, L) coordinates; slot 0 (digit 0)
    and slot half + 1 (overflow) are excluded.  Returns (W, L) coordinates."""
    body = tuple(c[:, 1 : half + 1].flip(1) for c in buckets)
    acc = _hs_prefix_scan(ops, body, half)
    g = half
    while g > 1:
        acc = ops.add(tuple(c[:, : g // 2] for c in acc), tuple(c[:, g // 2 : g] for c in acc))
        g //= 2
    return tuple(c[:, 0] for c in acc)
