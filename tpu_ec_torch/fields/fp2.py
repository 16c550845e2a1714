"""The quadratic extension Fq2 = Fq[u]/(u^2 + 1), the coordinates of G2.

PyTorch counterpart of ``tpu_ec/fields/fp2.py``: u^2 = -1 on both BLS12-381
and BN254, the product is the 3-product Karatsuba and the square the (a0 +
a1)(a0 - a1) form of the reference's ``field2.cl``.  An element is one
``(..., 2L)`` tensor, c0 in the first L half-limbs and c1 in the next L (the
column order of tpu_ec's fused G2 rows, so a Jacobian point fuses into one
``(..., 3 * 2L)`` row), in the base field's Montgomery form.  Every value is
canonical, so any exact evaluation of a product gives tpu_ec's bits.

``mul`` and ``sqr`` run their base products as one K1 launch on the card
(``FieldOps.mul`` on the stacked operands); the rest are plain tensor ops.
"""

from __future__ import annotations

import functools

import torch

from .fp import FieldOps, batch_inverse
from .limbs import resolve_device
from .params import FieldSpec


class Fp2Ops:
    """Batched Fq2 ops over one base :class:`FieldSpec` and one device, with
    the method surface of :class:`FieldOps` so that the point formulas are
    generic over the field."""

    def __init__(self, base: FieldSpec, device="cuda"):
        self.fp = FieldOps(base, device)
        self.spec = base
        self.device = self.fp.device
        self.dtype = self.fp.dtype
        self.L = self.fp.L  #: half-limbs of one component
        self.width = 2 * self.L  #: half-limbs of one element
        self.one = torch.cat([self.fp.one, self.fp.zero])
        self.zero = torch.zeros_like(self.one)

    def _parts(self, a):
        """(..., 2L) -> (..., 2, L): the base ops act on both components."""
        return a.reshape(*a.shape[:-1], 2, self.L)

    def _join(self, c):
        return c.reshape(*c.shape[:-2], self.width)

    def constant(self, c0: int, c1: int = 0, mont: bool = True) -> torch.Tensor:
        return torch.cat([self.fp.constant(c0, mont), self.fp.constant(c1, mont)])

    # -- predicates --------------------------------------------------------

    def eq(self, a, b):
        return (a == b).all(dim=-1)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def select(self, cond, a, b):
        return torch.where(cond.unsqueeze(-1), a, b)

    # -- ring ops (field2.cl) ------------------------------------------------

    def add(self, a, b):
        return self._join(self.fp.add(self._parts(a), self._parts(b)))

    def sub(self, a, b):
        return self._join(self.fp.sub(self._parts(a), self._parts(b)))

    def neg(self, a):
        return self._join(self.fp.neg(self._parts(a)))

    def double(self, a):
        return self.add(a, a)

    def _products(self, xs, ys):
        """The base products x_k y_k of equal-shape operands, as one K1 call."""
        return self.fp.mul(torch.stack(xs), torch.stack(ys)).unbind(0)

    def mul(self, a, b):
        """(a0 + a1 u)(b0 + b1 u) with u^2 = -1: 3 base products."""
        if b.shape != a.shape:
            b = b.expand_as(a)
        f, L = self.fp, self.L
        a0, a1, b0, b1 = a[..., :L], a[..., L:], b[..., :L], b[..., L:]
        aa, bb, o = self._products([a0, a1, f.add(a0, a1)], [b0, b1, f.add(b0, b1)])
        return torch.cat([f.sub(aa, bb), f.sub(f.sub(o, aa), bb)], dim=-1)

    def sqr(self, a):
        """(a0^2 - a1^2, 2 a0 a1) via (a0 + a1)(a0 - a1): 2 base products."""
        f, L = self.fp, self.L
        a0, a1 = a[..., :L], a[..., L:]
        ab, c0 = self._products([a0, f.add(a0, a1)], [a1, f.sub(a0, a1)])
        return torch.cat([c0, f.double(ab)], dim=-1)

    def mul_by_fp(self, a, k):
        """Scale both components by a base-field element ``k`` ((L,) or (..., L))."""
        return self._join(self.fp.mul(self._parts(a), k.unsqueeze(-2).expand(*a.shape[:-1], 2, self.L)))

    def inv_(self, a):
        """1 / (a0 + a1 u) = (a0 - a1 u) / (a0^2 + a1^2)."""
        f, L = self.fp, self.L
        a0, a1 = a[..., :L], a[..., L:]
        n0, n1 = self._products([a0, a1], [a0, a1])
        ninv = f.inv_(f.add(n0, n1))
        r0, r1 = self._products([a0, a1], [ninv, ninv])
        return torch.cat([r0, f.neg(r1)], dim=-1)

    def batch_inverse(self, a):
        """Montgomery batch inversion over the leading axis; zeros -> zeros."""
        return batch_inverse(self, a)

    # -- host conversion -----------------------------------------------------

    def from_ints(self, values, mont: bool = True) -> torch.Tensor:
        """(c0, c1) int pairs -> an (N, 2L) tensor on the device."""
        c0 = self.fp.from_ints([v[0] for v in values], mont)
        c1 = self.fp.from_ints([v[1] for v in values], mont)
        return torch.cat([c0, c1], dim=-1)

    def to_ints(self, a: torch.Tensor, mont: bool = True) -> list:
        """(..., 2L) tensor -> list of (c0, c1) int pairs."""
        a = a.reshape(-1, self.width)
        return list(zip(self.fp.to_ints(a[:, : self.L], mont), self.fp.to_ints(a[:, self.L :], mont)))


def fp2_ops(base: FieldSpec, device="cuda") -> Fp2Ops:
    """The process-wide :class:`Fp2Ops` over ``base`` on ``device``."""
    return _fp2_ops(base, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _fp2_ops(base: FieldSpec, device: torch.device) -> Fp2Ops:
    return Fp2Ops(base, device)
