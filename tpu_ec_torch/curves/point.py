"""Batched short-Weierstrass Jacobian point arithmetic (a = 0 curves, G1).

PyTorch counterpart of ``tpu_ec/curves/point.py``.  Point batches are tuples
of (..., L) half-limb tensors in Montgomery form:

  affine   (x, y)     with (0, 0) = identity
  jacobian (x, y, z)  with z = 0  = identity

``add``, ``add_mixed``, ``double`` and ``scalar_mul`` go through kernel K3
(``kernels/point.py``) for every batch size: its plain version on the CPU,
the CUDA kernel on the card (``scalar_mul`` as one launch of K3's chain
entry).  ``to_affine`` inverts every z with one Montgomery batch inversion,
and ``eq`` compares by cross-multiplication (kernel K1 for the products).
"""

from __future__ import annotations

import torch

from ..fields.fp import FieldOps
from ..fields.limbs import resolve_device
from ..kernels.point import point_op, point_scalar_mul
from .params import CurveSpec


def _prefix_products(F: FieldOps, a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 0 (Hillis-Steele, log depth)."""
    d = 1
    while d < a.shape[0]:
        a = torch.cat([a[:d], F.mul(a[d:], a[:-d])], dim=0)
        d *= 2
    return a


def _batch_inverse(F: FieldOps, a: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion of an (n, L) batch; zeros map to zeros."""
    iz = F.is_zero(a)
    one = F.one.expand_as(a)
    safe = F.select(iz, one, a)
    pre = _prefix_products(F, safe)
    suf = _prefix_products(F, safe.flip(0)).flip(0)
    total_inv = F.inv_(pre[-1:])
    left = torch.cat([one[:1], pre[:-1]], dim=0)
    right = torch.cat([suf[1:], one[:1]], dim=0)
    out = F.mul(F.mul(left, right), total_inv.expand_as(a))
    return F.select(iz, torch.zeros_like(a), out)


class PointOps:
    """Batched Jacobian group ops bound to one G1 :class:`CurveSpec` and device."""

    def __init__(self, spec: CurveSpec, device="cuda"):
        if spec.ext != 1:
            raise NotImplementedError("only G1 is ported; G2 needs the Fp2 port (ROADMAP.md queue 1, item 3)")
        self.spec = spec
        self.device = resolve_device(device)
        self.fq = FieldOps(spec.base, self.device)
        self.F = self.fq
        self.fr = FieldOps(spec.scalar, self.device)
        self.L = self.fq.L

    # -- constructors / predicates ----------------------------------------

    def identity_jacobian(self, batch_shape=()):
        z = torch.zeros(tuple(batch_shape) + (self.L,), dtype=self.fq.dtype, device=self.device)
        return (z, z.clone(), z.clone())

    def is_identity(self, P):
        return self.F.is_zero(P[2])

    def is_identity_affine(self, A):
        return self.F.is_zero(A[0]) & self.F.is_zero(A[1])

    def select(self, cond, P, Q):
        return tuple(self.F.select(cond, p, q) for p, q in zip(P, Q))

    def eq(self, P, Q):
        """Jacobian equality by cross-multiplication (no inversion): X1 Z2^2
        == X2 Z1^2 and Y1 Z2^3 == Y2 Z1^3; an identity equals only an
        identity."""
        F = self.F
        z1z1, z2z2 = F.sqr(P[2]), F.sqr(Q[2])
        x_eq = F.eq(F.mul(P[0], z2z2), F.mul(Q[0], z1z1))
        y_eq = F.eq(F.mul(P[1], F.mul(Q[2], z2z2)), F.mul(Q[1], F.mul(P[2], z1z1)))
        i1, i2 = self.is_identity(P), self.is_identity(Q)
        return torch.where(i1 | i2, i1 == i2, x_eq & y_eq)

    # -- conversions -------------------------------------------------------

    def to_jacobian(self, A):
        """Affine -> Jacobian; (0, 0) identity -> z = 0."""
        x, y = A
        z = self.F.select(
            self.is_identity_affine(A), torch.zeros_like(x), self.F.one.expand_as(x)
        )
        return (x, y, z)

    def to_affine(self, P):
        """Jacobian -> affine via one batched inversion of z (identity -> (0, 0))."""
        F = self.F
        z = P[2].reshape(-1, self.L)
        zinv = _batch_inverse(F, z).reshape(P[2].shape)
        zinv2 = F.sqr(zinv)
        x = F.mul(P[0], zinv2)
        y = F.mul(P[1], F.mul(zinv, zinv2))
        ident = self.is_identity(P)
        return (F.select(ident, torch.zeros_like(x), x), F.select(ident, torch.zeros_like(y), y))

    # -- group ops (kernel K3) ---------------------------------------------

    def double(self, P):
        """dbl-2009-l; identity-safe (Z3 = 2YZ = 0)."""
        return point_op(self.spec.base, "double", list(P))

    def add(self, P, Q, *, keep=None, out=None):
        """add-2007-bl with select-based completeness.  ``keep`` (bool, the
        batch shape): P where set instead of the sum; ``out``: a (..., 3L)
        destination for the fused result rows (see ``kernels.point.point_op``)."""
        return point_op(self.spec.base, "add", [*P, *Q], keep=keep, out=out)

    def add_mixed(self, P, A, *, keep=None, out=None):
        """madd-2007-bl: Jacobian + affine ((0, 0) = identity), the MSM hot op.
        P may be affine (x, y), lifted as :meth:`to_jacobian` does; ``keep``
        and ``out`` as for :meth:`add`."""
        return point_op(self.spec.base, "add_mixed", [*P, *A], keep=keep, out=out)

    def neg(self, P):
        return (P[0], self.F.neg(P[1]), P[2])

    def neg_affine(self, A):
        return (A[0], self.F.neg(A[1]))

    def sub(self, P, Q):
        """P - Q = P + (-Q) (PointOps.add, so P == Q gives z = 0 with the
        formula's x and y, as tpu_ec's does)."""
        return self.add(P, self.neg(Q))

    def scalar_mul(self, P, k):
        """[k] P by MSB-first double-and-add over 256 bits, bit-identical to
        tpu_ec's ``scalar_mul``.  ``k``: (..., 16) plain (non-Montgomery) Fr
        limbs that broadcast against P's batch; one scalar for every point
        (k of shape (16,) or (1, 16)) is not copied per row."""
        return point_scalar_mul(self.spec.base, list(P), k)

    # -- host conversion ----------------------------------------------------

    def from_affine_ints(self, points):
        """Oracle affine points (None = identity) -> (x, y) device batch."""
        xs = [0 if p is None else p[0] for p in points]
        ys = [0 if p is None else p[1] for p in points]
        return (self.fq.from_ints(xs), self.fq.from_ints(ys))

    def to_affine_ints(self, A):
        """(x, y) affine batch -> list of oracle points (None = identity)."""
        xs = self.F.to_ints(A[0])
        ys = self.F.to_ints(A[1])
        return [None if (x == 0 and y == 0) else (x, y) for x, y in zip(xs, ys)]

    def scalars_to_limbs(self, scalars) -> torch.Tensor:
        """Plain ints -> (N, Ls) non-Montgomery limbs for MSM digit extraction."""
        return self.fr.from_ints(list(scalars), mont=False)
