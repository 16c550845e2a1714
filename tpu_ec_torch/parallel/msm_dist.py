"""The distributed MSM: points sharded by rank, buckets combined across ranks.

PyTorch counterpart of ``tpu_ec/parallel/msm_dist.py``.  The reference
splits one MSM across GPUs and adds the partial results on the host
(``ec-gpu-proxy/src/multiexp.rs:324-400``); tpu_ec combines in bucket
space on the chips' links, and so does the port, rank by rank:

  1. local buckets of this rank's points at the GLOBAL window w, with the
     pair engine (config ``dist_msm_accum`` "pair", ``ops/msm_pair.py``) or
     the scan engine ("scan", ``ops/msm_scan.py``): (W, half + 2, 3L);
  2. the buckets 1..half cut into d slices of own = half / d, one
     ``all_to_all_single`` of (d, W, own, 3L) (slice j to rank j), then
     d - 1 K3 adds in source-rank order: rank s holds the whole buckets
     s own + 1 .. (s + 1) own;
  3. the own slice's tail, sum_j (base + j) b_j = base sum(b) + sum_j j b_j
     with base = s own: the masked prefix scan of the reversed slice
     (``masked_prefix_scan_add``; its last entry is sum(b)), its tree sum
     (``masked_tree_sum``) and ``scalar_mul_small`` of the sum by base;
  4. an ``all_gather`` of the (W, L) partials, added in rank order, and
     the Horner window combine (K3): every rank ends with the same point.

Every term scales with d: the accumulation with n / d, the tail with
half / d, the exchange with W half / d rows.  tpu_ec's default "scan"
accumulation is for XLA-CPU's compile time only (its pair engine takes
minutes to compile there); the port compiles nothing per shape, and its
default is "pair".
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from ..config import get_config, get_logger
from ..curves.params import CurveSpec
from ..curves.point import PointOps
from ..kernels.point import horner
from ..ops.msm import SCALAR_BITS, make_digits
from ..ops.msm_pair import default_window_size_pair, msm_pair_buckets
from ..ops.msm_scan import (_fused_add, _unfuse, masked_prefix_scan_add, masked_tree_sum, scalar_mul_small,
                            scan_buckets)
from .mesh import Mesh, all_gather_rows


def dist_window(n: int, d: int, window_size: int | None = None) -> int:
    """The window of a distributed MSM of n points (padded) over d ranks:
    ``window_size``, else the pair engine's model at n, raised until every
    rank owns at least one bucket (2^(w-1) >= d).  As tpu_ec's, the card's
    window table is not read."""
    w = window_size or default_window_size_pair(n)
    while (1 << (w - 1)) < d:
        w += 1
    return w


class DistMultiexpKernel:
    """The sharded MSM bound to one curve and mesh (the reference's
    multi-GPU ``MultiexpKernel::multiexp``)."""

    def __init__(self, spec: CurveSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh
        self.ops = PointOps(spec, mesh.device)

    def buckets(self, points, scalars: torch.Tensor, w: int) -> torch.Tensor:
        """Step 1: this rank's (W, half + 2, 3L) fused Jacobian buckets at
        window w (slot 0 the digit-0 dummy, slot half + 1 the overflow).
        ``scalars``: (n_loc, Ls + 1), zero-padded by one limb."""
        accum = get_config().dist_msm_accum
        if accum == "pair":
            return msm_pair_buckets(self.ops, points, scalars, window_size=w)
        if accum == "scan":
            digits = make_digits(scalars, w, -(-SCALAR_BITS // w), True)
            return scan_buckets(self.ops, points, digits.T, half=1 << (w - 1))
        raise ValueError(f"unknown dist_msm_accum {accum!r} (pair or scan)")

    def multiexp(self, bases_local, scalars_local: torch.Tensor, *, window_size: int | None = None):
        """sum_i scalars[i] * bases[i] over the whole mesh -> the same
        Jacobian point, batch (1,), on every rank; every rank of the mesh
        calls it together.

        ``bases_local`` are this rank's affine (x, y) of (n_loc, L) and
        ``scalars_local`` its (n_loc, Ls) plain scalar limbs, the slabs
        ``shard_leading`` gives of the global inputs (n_loc equal on every
        rank; padding rows are identities with zero scalars).  The window is
        ``dist_window(d n_loc, d, window_size)``."""
        ops, d, rank = self.ops, self.mesh.size, self.mesh.rank
        L = ops.width
        if d & (d - 1):
            raise ValueError(f"mesh size must be a power of two, got {d}")
        dev = self.mesh.device
        n_loc = scalars_local.shape[0]
        points = tuple(c.to(dev, ops.fq.dtype) for c in bases_local)
        s = scalars_local.to(dev, ops.fq.dtype)
        s = torch.cat([s, s.new_zeros((n_loc, 1))], dim=1)
        w = dist_window(d * n_loc, d, window_size)
        half = 1 << (w - 1)
        num_windows = -(-SCALAR_BITS // w)
        own = half // d
        get_logger("tpu_ec_torch.parallel").info(
            "distributed MSM n=%d over %d ranks curve=%s window=%d accum=%s",
            d * n_loc, d, self.spec.name, w, get_config().dist_msm_accum,
        )

        # 2. bucket slices across ranks: one exchange, d - 1 adds in rank order
        cur = self.buckets(points, s, w)[:, 1 : half + 1]  # (W, half, 3L): values 1..half
        send = cur.reshape(num_windows, d, own, 3 * L).transpose(0, 1).contiguous()  # (d, W, own, 3L)
        del cur
        recv = torch.empty_like(send)
        dist.all_to_all_single(recv, send, group=self.mesh.group)
        del send
        mine = recv[0]
        for j in range(1, d):
            mine = _fused_add(ops, mine, recv[j], L)
        del recv

        # 3. the own slice's tail, base = rank * own
        pre = masked_prefix_scan_add(ops, mine.flip(-2), L, own)
        tri = _unfuse(masked_tree_sum(ops, pre, L, own), L, 3)  # (W, L) each
        tot = _unfuse(pre[:, -1], L, 3)  # the slice's sum
        del pre
        nbits = max(1, (half - own).bit_length())
        part = ops.add(tri, scalar_mul_small(ops, tot, rank * own, nbits))

        # 4. every rank's partials, added in rank order, then Horner
        mine = torch.stack(part)  # (3, W, L)
        gathered = all_gather_rows(mine, self.mesh).view(d, *mine.shape)
        partials = tuple(gathered[0])
        for j in range(1, d):
            partials = ops.add(partials, tuple(gathered[j]))
        return horner(self.spec.base, partials, w, ext=self.spec.ext)
