"""Batched Montgomery prime-field arithmetic on 16-bit half-limbs.

PyTorch counterpart of ``tpu_ec/fields/fp.py``.  A batch of field elements
is an ``(..., L)`` tensor of little-endian 16-bit half-limbs in Montgomery
form (R = 2^(16L), arkworks' R), stored as int64 on the CPU and int32 on
CUDA.  Values are canonical (< p) at every op boundary.

``mul``/``sqr``/``to_mont``/``from_mont`` go through kernel K1
(``kernels/mont.py``): its plain version on the CPU, the CUDA kernel on the
card.  The rest are plain tensor ops on either device, as ``tpu_ec``
computes them in jnp too.  :func:`batch_inverse` is generic over the
field-ops object, so ``fields/fp2.py``'s Fp2 uses it too.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..kernels.mont import mont_mul
from ..utils.timer import phase
from .limbs import LIMB_BITS, LIMB_MASK, add_plain, resolve_device, storage_dtype, sub_borrow, sub_plain
from .params import FieldSpec, int_to_limbs, limbs_to_int


def _prefix_products(F, a: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix products along axis 0 (Hillis-Steele, log depth)."""
    d = 1
    while d < a.shape[0]:
        a = torch.cat([a[:d], F.mul(a[d:], a[:-d])], dim=0)
        d *= 2
    return a


def batch_inverse(F, a: torch.Tensor) -> torch.Tensor:
    """Montgomery batch inversion over the leading axis of an (n, ...)
    batch, generic over the field-ops object ``F`` (FieldOps or Fp2Ops):
    prefix and suffix products, one inversion of the total; zeros map to
    zeros."""
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


class FieldOps:
    """Batched field ops bound to one :class:`FieldSpec` and one device."""

    def __init__(self, spec: FieldSpec, device="cuda"):
        self.spec = spec
        self.device = resolve_device(device)
        self.dtype = storage_dtype(self.device)
        self.L = spec.n_limbs
        self.p = self._t(spec.p_limbs)
        self.one = self._t(spec.one_limbs)  # Montgomery 1
        self.zero = torch.zeros_like(self.one)
        self.r2 = self._t(spec.r2_limbs)
        self.unit = self._t(int_to_limbs(1, self.L))  # plain 1, for from_mont

    def _t(self, limbs) -> torch.Tensor:
        with phase("wait/upload_constant"):  # a copy from pageable host memory
            return torch.as_tensor(np.asarray(limbs, np.int64), device=self.device).to(self.dtype)

    def constant(self, value: int, mont: bool = True) -> torch.Tensor:
        """A Python-int field element as an (L,) limb tensor on the device."""
        v = self.spec.to_mont(value % self.spec.modulus) if mont else value
        return self._t(int_to_limbs(v, self.L))

    # -- predicates --------------------------------------------------------

    def eq(self, a, b):
        return (a == b).all(dim=-1)

    def is_zero(self, a):
        return (a == 0).all(dim=-1)

    def gte(self, a, b):
        """a >= b as integers (bool, the batch shape)."""
        _, borrow = sub_borrow(a.to(torch.int64), b.to(torch.int64))
        return ~borrow

    def select(self, cond, a, b):
        """Elementwise select; ``cond`` has the batch shape (no limb axis)."""
        return torch.where(cond.unsqueeze(-1), a, b)

    # -- ring ops ----------------------------------------------------------

    def add(self, a, b):
        return add_plain(self.spec, a.to(torch.int64), b.to(torch.int64)).to(self.dtype)

    def sub(self, a, b):
        return sub_plain(self.spec, a.to(torch.int64), b.to(torch.int64)).to(self.dtype)

    def neg(self, a):
        a64 = a.to(torch.int64)
        d, _ = sub_borrow(self.p.to(torch.int64).expand_as(a64), a64)
        return torch.where(self.is_zero(a).unsqueeze(-1), a64, d).to(self.dtype)

    def double(self, a):
        return self.add(a, a)

    def mul(self, a, b):
        """Montgomery product a*b*R^-1 mod p (kernel K1)."""
        if b.shape != a.shape and b.dim() > 1:
            b = b.expand_as(a).contiguous()
        return mont_mul(self.spec, a.contiguous(), b.contiguous())

    def sqr(self, a):
        return self.mul(a, a)

    def to_mont(self, a):
        return self.mul(a, self.r2)

    def from_mont(self, a):
        return self.mul(a, self.unit)

    def pow(self, base, exponent: int):
        """base^exponent with one shared Python-int exponent, MSB first."""
        acc = self.one.expand_as(base).contiguous()
        for bit in bin(exponent)[2:]:
            acc = self.sqr(acc)
            if bit == "1":
                acc = self.mul(acc, base)
        return acc

    def inv_(self, a):
        """Field inverse via Fermat (a^(p-2)); in-domain for Montgomery reps."""
        return self.pow(a, self.spec.modulus - 2)

    def pow_table(self, base) -> torch.Tensor:
        """(16 L, ..., L) table of base^(2^i), shared across exponents."""
        table = [base]
        for _ in range(self.L * LIMB_BITS - 1):
            table.append(self.sqr(table[-1]))
        return torch.stack(table)

    def pow_lookup(self, table, exponent):
        """base^exponent from a :meth:`pow_table` table; ``exponent``: (...,
        L) plain limbs that broadcast against the table's batch shape.  LSB
        first, one product a set bit, as tpu_ec's (a bit no row has set is
        skipped: the select keeps the accumulator there)."""
        e = exponent.to(torch.int64)
        shape = torch.broadcast_shapes(table.shape[1:], e.shape[:-1] + (self.L,))
        acc = self.one.expand(shape).contiguous()
        for i in range(self.L * LIMB_BITS):
            bit = ((e[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1) == 1
            if bool(bit.any()):
                acc = self.select(bit.expand(shape[:-1]), self.mul(acc, table[i].expand(shape)), acc)
        return acc

    def batch_inverse(self, a):
        """Montgomery batch inversion over the leading axis; zeros -> zeros."""
        return batch_inverse(self, a)

    # -- bit extraction and packing -----------------------------------------

    def get_bits(self, a, skip: int, width: int):
        """MSB-first window: bits [16 L - skip - width, 16 L - skip) of the
        plain limbs ``a``, as an integer of the batch shape."""
        a = a.to(torch.int64)
        lo = self.L * LIMB_BITS - skip - width
        acc = torch.zeros(a.shape[:-1], dtype=torch.int64, device=a.device)
        for w in range(width):
            i = lo + w
            acc |= ((a[..., i // LIMB_BITS] >> (i % LIMB_BITS)) & 1) << w
        return acc

    def pack(self, a):
        """Half-limbs (..., L) -> (..., L / 2) 32-bit words, int64."""
        a = a.to(torch.int64)
        return a[..., 0::2] | (a[..., 1::2] << LIMB_BITS)

    def unpack(self, a32):
        """32-bit words (..., L / 2) -> half-limbs (..., L) in the storage dtype."""
        a32 = a32.to(torch.int64)
        return torch.stack([a32 & LIMB_MASK, a32 >> LIMB_BITS], dim=-1).reshape(
            *a32.shape[:-1], self.L).to(self.dtype)

    # -- host conversion ---------------------------------------------------

    def from_ints(self, values, mont: bool = True) -> torch.Tensor:
        """Python ints -> (N, L) limb tensor on the device."""
        arr = np.zeros((len(values), self.L), dtype=np.int64)
        for i, v in enumerate(values):
            v %= self.spec.modulus
            arr[i] = int_to_limbs(self.spec.to_mont(v) if mont else v, self.L)
        return torch.as_tensor(arr, device=self.device).to(self.dtype)

    def to_ints(self, a: torch.Tensor, mont: bool = True) -> list:
        """(..., L) limb tensor -> list of Python ints."""
        arr = a.detach().to("cpu", torch.int64).reshape(-1, self.L).numpy()
        out = [limbs_to_int(r) for r in arr]
        return [self.spec.from_mont(v) for v in out] if mont else out


def field_ops(spec: FieldSpec, device="cuda") -> FieldOps:
    """The process-wide :class:`FieldOps` of ``spec`` on ``device`` (one per
    field and device, as tpu_ec's ``field_ops`` keeps one per field)."""
    return _field_ops(spec, resolve_device(device))


@functools.lru_cache(maxsize=None)
def _field_ops(spec: FieldSpec, device: torch.device) -> FieldOps:
    return FieldOps(spec, device)
