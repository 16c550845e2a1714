"""Plain PyTorch prime-field arithmetic on 16-bit limbs, and the radix-2 NTT.

An element is a trailing axis of ``L`` little-endian 16-bit limbs held in
int64, canonical (below the modulus).  Products are schoolbook column sums
and word-serial Montgomery reduction with R = 2^(16 L); carries run one limb
at a time.  It is written for clarity, not speed: on the card a 2^20-point
NTT takes well under a second, which is all the benchmark's check needs.
"""

from __future__ import annotations

import numpy as np
import torch

MASK = 0xFFFF


def ints_to_limbs(values, L: int) -> np.ndarray:
    """Non-negative ints below 2^(16 L) -> (len, L) int64 limbs."""
    raw = b"".join(int(v).to_bytes(2 * L, "little") for v in values)
    return np.frombuffer(raw, dtype="<u2").reshape(-1, L).astype(np.int64)


def limbs_to_ints(arr) -> list[int]:
    """(..., L) limbs (numpy or tensor, values < 2^16) -> ints, row-major."""
    if isinstance(arr, torch.Tensor):
        arr = arr.detach().to("cpu", torch.int64).numpy()
    a = np.ascontiguousarray(np.asarray(arr).astype("<u2"))
    L = a.shape[-1]
    raw = a.reshape(-1, L).tobytes()
    return [int.from_bytes(raw[i : i + 2 * L], "little") for i in range(0, len(raw), 2 * L)]


def bit_reverse(log_n: int) -> np.ndarray:
    idx = np.arange(1 << log_n)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


class LimbField:
    """Z/pZ on (..., L) int64 limb tensors of one device."""

    def __init__(self, modulus: int, L: int, device="cpu"):
        if modulus >= 1 << (16 * L - 1):
            raise ValueError("the modulus needs a spare bit in L limbs")
        self.p, self.L, self.device = modulus, L, torch.device(device)
        self.R = 1 << (16 * L)
        self.p_t = torch.as_tensor(ints_to_limbs([modulus], L)[0], device=self.device)
        self.ninv = (-pow(modulus, -1, 1 << 16)) % (1 << 16)
        self.r2 = self.const(self.R * self.R % modulus)
        self.one_plain = self.const(1)

    def const(self, v: int) -> torch.Tensor:
        return torch.as_tensor(ints_to_limbs([v % self.p], self.L)[0], device=self.device)

    def tensor(self, values) -> torch.Tensor:
        return torch.as_tensor(ints_to_limbs([v % self.p for v in values], self.L), device=self.device)

    def _carry(self, t: torch.Tensor) -> torch.Tensor:
        """Propagate carries (or borrows) limb by limb; the top limb keeps the rest."""
        for j in range(t.shape[-1] - 1):
            c = t[..., j] >> 16  # arithmetic shift: a borrow is -1
            t[..., j] &= MASK
            t[..., j + 1] += c
        return t

    def _reduce_once(self, t: torch.Tensor) -> torch.Tensor:
        """(..., L + 1) normalised limbs of a value in [0, 2p) -> canonical (..., L)."""
        d = t.clone()
        d[..., : self.L] -= self.p_t
        d = self._carry(d)
        return torch.where((d[..., self.L] >= 0)[..., None], d[..., : self.L], t[..., : self.L])

    def add(self, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        t = torch.zeros(shape[:-1] + (self.L + 1,), dtype=torch.int64, device=self.device)
        t[..., : self.L] = a + b
        return self._reduce_once(self._carry(t))

    def sub(self, a, b):
        shape = torch.broadcast_shapes(a.shape, b.shape)
        t = torch.zeros(shape[:-1] + (self.L + 1,), dtype=torch.int64, device=self.device)
        t[..., : self.L] = a - b
        t = self._carry(t)
        neg = t[..., self.L] < 0
        t[..., : self.L] += torch.where(neg[..., None], self.p_t, torch.zeros_like(self.p_t))
        t[..., self.L] = 0
        return self._carry(t)[..., : self.L]

    def mont_mul(self, a, b):
        """a b R^-1 mod p for canonical a, b (any a, b below R whose product is below R p)."""
        L = self.L
        shape = torch.broadcast_shapes(a.shape, b.shape)
        t = torch.zeros(shape[:-1] + (2 * L + 1,), dtype=torch.int64, device=self.device)
        a, b = a.expand(shape), b.expand(shape)
        for i in range(L):
            t[..., i : i + L] += a[..., i : i + 1] * b
        for i in range(L):
            m = ((t[..., i] & MASK) * self.ninv) & MASK
            t[..., i : i + L] += m[..., None] * self.p_t
            t[..., i + 1] += t[..., i] >> 16
        return self._reduce_once(self._carry(t[..., L:].clone()))

    def mul(self, a, b):
        """a b mod p (two Montgomery products)."""
        return self.mont_mul(self.mont_mul(a, b), self.r2)

    def from_mont(self, a):
        """a R^-1 mod p: the plain value of a Montgomery-form element."""
        return self.mont_mul(a, self.one_plain)

    def powers(self, w: int, count: int, mont: bool = True) -> torch.Tensor:
        """(count, L): w^j (times R where ``mont``) for j < count."""
        vals, x = [], self.R % self.p if mont else 1
        for _ in range(count):
            vals.append(x)
            x = x * w % self.p
        return self.tensor(vals)

    def ntt(self, x: torch.Tensor, omega: int, table: torch.Tensor | None = None) -> torch.Tensor:
        """X_k = sum_j x_j omega^(jk) along axis -2 (natural order in and
        out): radix-2 decimation in time after a bit reversal.  ``table``
        replaces the twiddles omega^j R (Montgomery form), j < n / 2."""
        n = x.shape[-2]
        log_n = n.bit_length() - 1
        if n != 1 << log_n:
            raise ValueError(f"NTT size must be a power of two, got {n}")
        lead = x.shape[:-2]
        x = x.index_select(-2, torch.as_tensor(bit_reverse(log_n), device=self.device))
        if table is None:
            table = self.powers(omega, max(n // 2, 1))
        m = 1
        while m < n:
            tw = table[:: n // (2 * m)][:m]
            blocks = x.reshape(*lead, n // (2 * m), 2, m, self.L)
            u = blocks[..., 0, :, :]
            v = self.mont_mul(blocks[..., 1, :, :], tw)
            x = torch.stack([self.add(u, v), self.sub(u, v)], dim=-3).reshape(*lead, n, self.L)
            m *= 2
        return x
