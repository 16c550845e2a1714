"""Batch-affine and co-Z point addition with a shared product tree.

PyTorch counterpart of ``tpu_ec/ops/pallas/affine.py``.  Points are affine
(x, y) coordinate tensors (..., n, L), (0, 0) = the identity; every leading
axis is a batch of independent problems (the co-Z MSM's windows), and each
product tree runs along the row axis -2 of its own problem.

- :func:`affine_add_batch`: the denominators (kernel K7, denom half), one
  Montgomery batch inversion (a contiguous-halves product tree of K1
  launches, one Fermat inversion at each root), then the apply (K7, apply
  half): ~7 products per add instead of 11 for a Jacobian mixed add.
- :func:`coz_add_batch`: the same denominators, the inversion-free partial
  products P_i = prod_{j != i} d_j and the root r = prod_j d_j, then the
  co-Z apply (kernel K6) with r^2, r^3 of each problem: outputs at the
  common scale Z * r, no inversion at all.

Trees are padded to a power of two with Montgomery one, as in tpu_ec, and
their products are field values, so every output is bit-identical.
"""

from __future__ import annotations

import functools

import torch

from ..fields.fp import FieldOps
from ..fields.params import FieldSpec
from ..kernels.affine import affine_apply, affine_denom, coz_apply


@functools.lru_cache(maxsize=16)
def _field(spec: FieldSpec, device: torch.device) -> FieldOps:
    return FieldOps(spec, device)


def _up_sweep(F: FieldOps, d: torch.Tensor):
    """Pad the rows of d (..., n, L) to a power of two with Montgomery one
    and multiply contiguous halves up to the (..., 1, L) root.  Returns
    (levels, root)."""
    n = d.shape[-2]
    npad = 1 << max(0, (n - 1).bit_length())
    if npad != n:
        d = torch.cat([d, F.one.expand(d.shape[:-2] + (npad - n, F.L))], dim=-2)
    levels = []
    cur = d
    while cur.shape[-2] > 1:
        m = cur.shape[-2] // 2
        levels.append(cur)
        cur = F.mul(cur[..., :m, :], cur[..., m:, :])
    return levels, cur


def _down_sweep(F: FieldOps, levels, top: torch.Tensor, n: int) -> torch.Tensor:
    """From each node's value at ``top`` down: a left child gets the
    parent's value times its right sibling's product, and the other way."""
    cur = top
    for lev in reversed(levels):
        m = lev.shape[-2] // 2
        swapped = torch.cat([lev[..., m:, :], lev[..., :m, :]], dim=-2)
        cur = F.mul(torch.cat([cur, cur], dim=-2), swapped)
    return cur[..., :n, :]


def partial_products(spec: FieldSpec, d: torch.Tensor):
    """(P, r): P[i] = prod_{j != i} d[j] along the rows of each problem, and
    r = prod_j d[j] as (..., 1, L) (``partial_products_planes``)."""
    F = _field(spec, d.device)
    levels, root = _up_sweep(F, d)
    return _down_sweep(F, levels, F.one.expand(root.shape), d.shape[-2]), root


def batch_inverse(spec: FieldSpec, d: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion along the rows of each problem
    (``batch_inverse_planes``); the inputs must be nonzero (the
    denominators of :func:`affine_denom` are)."""
    F = _field(spec, d.device)
    levels, root = _up_sweep(F, d)
    return _down_sweep(F, levels, F.inv_(root), d.shape[-2])


def coz_add_batch(spec: FieldSpec, A, B):
    """Complete co-Z pair add of A, B (affine (x, y) tuples of (..., n, L))
    that share one implicit scale Z per problem.  Returns ((x3, y3), r) with
    the outputs at scale Z * r, r of shape (..., 1, L): callers fold r into
    their running scale."""
    x1, y1 = A
    x2, y2 = B
    d = affine_denom(spec, x1, y1, x2, y2)
    pp, r1 = partial_products(spec, d)
    F = _field(spec, d.device)
    r2 = F.sqr(r1)
    r3 = F.mul(r2, r1)
    return coz_apply(spec, x1, y1, x2, y2, pp, r2, r3), r1


def affine_add_batch(spec: FieldSpec, A, B):
    """Complete batched affine add A + B -> affine (x3, y3); (0, 0) = the
    identity, P + (-P) = (0, 0)."""
    x1, y1 = A
    x2, y2 = B
    d = affine_denom(spec, x1, y1, x2, y2)
    return affine_apply(spec, x1, y1, x2, y2, batch_inverse(spec, d))
