"""Batched short-Weierstrass Jacobian point arithmetic (a = 0 curves, G1 and G2).

PyTorch counterpart of ``tpu_ec/curves/point.py``, generic over the field
as tpu_ec's is: G1 coordinates are (..., L) half-limb tensors of Fq
(:class:`FieldOps`), G2 coordinates (..., 2L) tensors of Fq2 (:class:`Fp2Ops`,
c0 then c1), both in Montgomery form; ``PointOps.width`` is a coordinate's
half-limbs, ext * L.  Point batches are tuples of coordinates:

  affine   (x, y)     with (0, 0) = identity
  jacobian (x, y, z)  with z = 0  = identity

``add``, ``add_mixed``, ``double`` and ``scalar_mul`` go through kernel K3
(``kernels/point.py``) for every batch size, its Fq2 instances on G2: its
plain version on the CPU, the CUDA kernel on the card (``scalar_mul`` as one
launch of K3's chain entry).  ``to_affine`` inverts every z with one
Montgomery batch inversion, and ``eq`` compares by cross-multiplication
(kernel K1 for the products).
"""

from __future__ import annotations

import functools

import torch

from ..fields.fp import FieldOps
from ..fields.fp2 import Fp2Ops
from ..fields.limbs import resolve_device
from ..kernels.point import point_op, point_scalar_mul
from .params import CurveSpec


class PointOps:
    """Batched Jacobian group ops bound to one :class:`CurveSpec` (G1 or G2)
    and device."""

    def __init__(self, spec: CurveSpec, device="cuda"):
        if spec.ext not in (1, 2):
            raise ValueError(f"ext must be 1 (G1) or 2 (G2), got {spec.ext}")
        self.spec = spec
        self.device = resolve_device(device)
        self.fq = FieldOps(spec.base, self.device)
        self.F = self.fq if spec.ext == 1 else Fp2Ops(spec.base, self.device)
        self.fr = FieldOps(spec.scalar, self.device)
        self.L = self.fq.L  #: half-limbs of one Fq element
        self.width = spec.ext * self.L  #: half-limbs of one coordinate

    # -- constructors / predicates ----------------------------------------

    @functools.cached_property
    def generator_affine(self):
        """(x, y) of the subgroup generator, Montgomery, batch shape ()."""
        x, y = self.from_affine_ints([(self.spec.gen_x, self.spec.gen_y)])
        return x[0], y[0]

    def identity_jacobian(self, batch_shape=()):
        z = torch.zeros(tuple(batch_shape) + (self.width,), dtype=self.fq.dtype, device=self.device)
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
        zinv = F.batch_inverse(P[2].reshape(-1, self.width)).reshape(P[2].shape)
        zinv2 = F.sqr(zinv)
        x = F.mul(P[0], zinv2)
        y = F.mul(P[1], F.mul(zinv, zinv2))
        ident = self.is_identity(P)
        return (F.select(ident, torch.zeros_like(x), x), F.select(ident, torch.zeros_like(y), y))

    # -- group ops (kernel K3) ---------------------------------------------

    def double(self, P):
        """dbl-2009-l; identity-safe (Z3 = 2YZ = 0)."""
        return point_op(self.spec.base, "double", list(P), ext=self.spec.ext)

    def add(self, P, Q, *, keep=None, out=None):
        """add-2007-bl with select-based completeness.  ``keep`` (bool, the
        batch shape): P where set instead of the sum; ``out``: a (..., 3 width)
        destination for the fused result rows (see ``kernels.point.point_op``)."""
        return point_op(self.spec.base, "add", [*P, *Q], keep=keep, out=out, ext=self.spec.ext)

    def add_mixed(self, P, A, *, keep=None, out=None):
        """madd-2007-bl: Jacobian + affine ((0, 0) = identity), the MSM hot op.
        P may be affine (x, y), lifted as :meth:`to_jacobian` does; ``keep``
        and ``out`` as for :meth:`add`."""
        return point_op(self.spec.base, "add_mixed", [*P, *A], keep=keep, out=out, ext=self.spec.ext)

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
        return point_scalar_mul(self.spec.base, list(P), k, ext=self.spec.ext)

    # -- host conversion ----------------------------------------------------

    def from_affine_ints(self, points):
        """Oracle affine points (None = identity; G2 coordinates (c0, c1)
        pairs) -> (x, y) device batch."""
        zero = 0 if self.spec.ext == 1 else (0, 0)
        xs = [zero if p is None else p[0] for p in points]
        ys = [zero if p is None else p[1] for p in points]
        return (self.F.from_ints(xs), self.F.from_ints(ys))

    def to_affine_ints(self, A):
        """(x, y) affine batch -> list of oracle points (None = identity)."""
        zero = 0 if self.spec.ext == 1 else (0, 0)
        xs = self.F.to_ints(A[0])
        ys = self.F.to_ints(A[1])
        return [None if (x == zero and y == zero) else (x, y) for x, y in zip(xs, ys)]

    def scalars_to_limbs(self, scalars) -> torch.Tensor:
        """Plain ints -> (N, Ls) non-Montgomery limbs for MSM digit extraction."""
        return self.fr.from_ints(list(scalars), mont=False)


def point_ops(spec: CurveSpec, device="cuda") -> PointOps:
    """The process-wide :class:`PointOps` of ``spec`` on ``device``."""
    return _point_ops(spec, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _point_ops(spec: CurveSpec, device: torch.device) -> PointOps:
    return PointOps(spec, device)
