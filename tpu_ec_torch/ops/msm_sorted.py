"""Sort-based Pippenger MSM engine: run-halving rounds over sorted buckets.

PyTorch counterpart of ``tpu_ec/ops/msm_sorted.py``.  Per window (every
tensor has an explicit leading window axis, so each round is one batched
point op over all windows, where tpu_ec maps the windows with
``lax.map``):

  1. sort the keys |digit| (stable, as ``lax.sort_key_val``) and gather the
     points into key order as fused (n, 2L) affine rows, y negated where
     the digit is negative;
  2. run-halving rounds: the entry at an even place within its run of equal
     keys adds its odd successor (one K3 launch a round, ``add_mixed`` in
     the first round, where the rows are still affine, ``add`` after it)
     and the survivors are compacted into a shorter array; the rounds
     shrink while the geometric term dominates (``_plan_sizes``), then
     ceil(log2 s) rounds at a constant size s finish any run length left,
     the worst case of equal scalars included (tpu_ec's ``fori_loop``);
  3. every run now has one entry: it scatters into a (half + 2)-slot bucket
     array (slot 0 the digit-0 dummy, slot half + 1 the sentinels), then
     the triangular tail sum_k k * b_k (``ops/msm_scan.py::bucket_tail``,
     tpu_ec's ``_triangular_sum``) and the Horner window combine (K3).

The bits equal tpu_ec's at every step, so the engine's Jacobian result is
tpu_ec's.
"""

from __future__ import annotations

import math

import torch

from ..curves.point import PointOps
from ..kernels.point import horner
from ..utils.timer import phase
from .msm import SCALAR_BITS, make_digits
from .msm_scan import _fuse, _unfuse, bucket_tail, sorted_affine_rows

SENT = torch.iinfo(torch.int32).max


def default_window_size_sorted(n: int) -> int:
    """Window bits minimising W (1.1 n + 3 B log2 B), B = 2^(w-1): tpu_ec's
    work model of the engine (halving rounds, the fixed-point rounds and
    the triangular tail), w in [2, 16]."""
    if n <= 1:
        return 2
    best_w, best_cost = 2, float("inf")
    for w in range(2, 17):
        W = -(-SCALAR_BITS // w)
        B = 1 << (w - 1)
        cost = W * (1.1 * n + 3 * B * max(1, w - 1))
        if cost < best_cost:
            best_w, best_cost = w, cost
    return best_w


def _plan_sizes(n: int, half: int) -> list[int]:
    """Static compaction sizes for the shrinking halving rounds: shrink while
    the geometric term dominates the ~(half + 6) fixed point, then hand off to
    the constant-size rounds."""
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


def fixup_rounds(s: int) -> int:
    """Constant-size rounds that finish any run in an array of s entries."""
    return max(1, math.ceil(math.log2(s))) if s > 1 else 0


def sorted_steps(n: int, w: int) -> dict:
    """K3 launches of ``msm_sorted`` on n points at window w: one a halving
    round, the prefix scan and the tree of the tail, one Horner."""
    sizes = _plan_sizes(n, 1 << (w - 1))
    s_f = sizes[-1] if sizes else n
    return {"halving": len(sizes), "fixup": fixup_rounds(s_f), "tail": 2 * (w - 1), "horner": 1}


def _halving_round(ops: PointOps, key: torch.Tensor, data: torch.Tensor, s_out: int, *, affine: bool):
    """One run-halving round over sorted keys (..., s) and fused rows
    (..., s, k L) (k = 2, affine, with ``affine``; else 3, Jacobian; L =
    ``ops.width``) -> keys (..., s_out) and fused Jacobian rows
    (..., s_out, 3L).

    The entry at an even place within its run pairs with its odd successor
    (one batched K3 op over all pairs); the survivors (pair sums and
    unpaired evens) are compacted in order into s_out slots, the unused
    ones (sentinel key, identity).  Each run of length len leaves
    ceil(len / 2) survivors, at most s // 2 + half // 2 + 2 <= s_out over
    the half + 2 keys (the callers size s_out so)."""
    L = ops.width
    lead, s = key.shape[:-1], key.shape[-1]
    B = math.prod(lead)
    key = key.reshape(B, s)
    data = data.reshape(B, s, data.shape[-1])
    dev = key.device
    i = torch.arange(s, device=dev)
    first = torch.ones_like(key, dtype=torch.bool)
    first[:, 1:] = key[:, 1:] != key[:, :-1]
    start = torch.cummax(torch.where(first, i, 0), dim=1).values
    even = ((i - start) & 1) == 0
    nxt_same = torch.zeros_like(first)
    nxt_same[:, :-1] = ~first[:, 1:]
    paired = even & nxt_same

    # survivor i goes to slot c[i]; the others to slot s_out, cut below
    c = torch.cumsum(even, dim=1) - 1
    tgt = torch.where(even & (c < s_out), c, s_out)
    sel = torch.full((B, s_out + 1), s, dtype=torch.int64, device=dev)
    sel.scatter_(1, tgt, i.expand(B, s))
    sel = sel[:, :s_out]  # source row of each slot; s: the appended sentinel
    key_ext = torch.cat([key, key.new_full((B, 1), SENT)], dim=1)
    new_key = torch.gather(key_ext, 1, sel)
    paired_s = torch.gather(torch.cat([paired, paired.new_zeros((B, 1))], dim=1), 1, sel)
    sel_b = torch.where(paired_s, sel + 1, s)  # the partner, or the identity row

    # one gather each of the left and right operands from the rows and an
    # appended identity row ((0, 0) affine, z = 0 Jacobian: all zeros)
    rows = torch.cat([data, data.new_zeros((B, 1, data.shape[-1]))], dim=1).reshape(B * (s + 1), -1)
    ofs = (torch.arange(B, device=dev) * (s + 1)).unsqueeze(1)
    a = rows.index_select(0, (sel + ofs).reshape(-1))
    b = rows.index_select(0, (sel_b + ofs).reshape(-1))
    k = 2 if affine else 3
    out = data.new_empty((B * s_out, 3 * L))
    if affine:  # the left entry affine too, lifted as to_jacobian lifts it
        ops.add_mixed(_unfuse(a, L, 2), _unfuse(b, L, 2), out=out)
    else:
        ops.add(_unfuse(a, L, k), _unfuse(b, L, k), out=out)
    return new_key.reshape(*lead, s_out), out.reshape(*lead, s_out, 3 * L)


def msm_sorted(ops: PointOps, points, scalars: torch.Tensor, *, window_size: int, signed: bool = True):
    """One MSM on the sorted engine: affine (x, y) of (n, L) ((0, 0) =
    identity; L = ``ops.width``) and (n, Ls + 1) plain zero-padded scalar
    limbs -> one Jacobian point, batch (1,)."""
    if not signed:
        raise ValueError("the sorted engine takes signed digits only; use method='lattice'")
    L = ops.width
    w = window_size
    num_windows = -(-SCALAR_BITS // w)
    half = 1 << (w - 1)
    n = scalars.shape[0]
    nbuckets = half + 2

    with phase("msm/digits"):
        digits_t = make_digits(scalars, w, num_windows, True).T  # (W, n)
    key, data = sorted_affine_rows(ops, points, digits_t)  # (W, n), (W, n, 2L)
    del digits_t

    sizes = _plan_sizes(n, half)
    for r, s_out in enumerate(sizes):
        key, data = _halving_round(ops, key, data, s_out, affine=(r == 0))
    if not sizes:  # tiny n: no halving ran; lift for the fix-up rounds
        data = _fuse(ops.to_jacobian(_unfuse(data, L, 2)))
    s_f = key.shape[1]
    for _ in range(fixup_rounds(s_f)):
        key, data = _halving_round(ops, key, data, s_f, affine=False)

    # one entry a run: straight into the buckets (sentinels to the last slot)
    slot = key.clamp(max=nbuckets - 1).long()
    buckets = data.new_zeros((num_windows, nbuckets, 3 * L))
    buckets.scatter_(1, slot.unsqueeze(-1).expand(data.shape), data)
    tri = bucket_tail(ops, buckets, half)  # (W, 3L)
    with phase("msm/horner"):
        return horner(ops.spec.base, _unfuse(tri, L, 3), w, ext=ops.spec.ext)
