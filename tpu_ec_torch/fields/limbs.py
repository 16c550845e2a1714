"""Plain PyTorch multi-limb integer arithmetic on 16-bit half-limbs.

The port keeps the reference value layout: an integer is a trailing axis of
little-endian 16-bit digits.  Storage is ``torch.int64`` on the CPU and
``torch.int32`` on CUDA (:func:`storage_dtype`); the values are below 2^16,
so both hold them exactly.  Every helper here computes in int64, where a
16x16-bit product (< 2^32) and a sum of a few hundred of them fit with room
to spare, so column sums never need the lo/hi split the TPU needed.

Carries and borrows run as whole-tensor passes repeated until none is
left (a few passes: carries shrink by 16 bits a pass, then a residual 0/1
ripples through runs of 0xFFFF digits), instead of ``tpu_ec``'s Kogge-Stone
lookahead, which costs more tensor ops per call here.  These helpers
are the plain versions behind the field, point and twiddle kernels; the
CUDA kernels replace them on the card.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..errors import DeviceError
from ..utils.timer import phase
from .params import FieldSpec

LIMB_BITS = 16
LIMB_MASK = (1 << LIMB_BITS) - 1


def resolve_device(device) -> torch.device:
    """The device an entry point runs on.  The entry points default to
    ``"cuda"``; without a card that raises instead of carrying on on the
    CPU, which a caller has to ask for (``device="cpu"``)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise DeviceError("no CUDA device: pass device='cpu' to run the plain versions")
    return dev


def storage_dtype(device) -> torch.dtype:
    """Limb storage dtype on ``device``: int64 on the CPU, int32 on CUDA
    (torch's uint32 has no ``+`` or ``>>`` on the CPU)."""
    return torch.int64 if torch.device(device).type == "cpu" else torch.int32


def _fit(x: torch.Tensor, n: int) -> torch.Tensor:
    """A new tensor: the last axis of x cut or zero-extended to n entries."""
    k = x.shape[-1]
    if k >= n:
        return x[..., :n].clone()
    out = x.new_zeros(x.shape[:-1] + (n,))
    out[..., :k] = x
    return out


def normalize(cols: torch.Tensor, n_out: int) -> torch.Tensor:
    """int64 column sums (..., k), each in [0, 2^62) -> the n_out base-2^16
    digits of their weighted sum mod 2^(16 n_out).

    Parallel carry passes until no digit carries: a pass shrinks carries by
    16 bits, and a residual 0/1 carry ripples one digit per pass through
    runs of 0xFFFF digits.  The first three passes run without a check."""
    x = _fit(cols, n_out)
    passes = 0
    while True:
        c = x >> LIMB_BITS
        if passes >= 3:
            with phase("wait/carry_test"):
                done = not bool(c.any())
            if done:
                return x
        x &= LIMB_MASK
        x[..., 1:] += c[..., :-1]
        passes += 1


def sub_borrow(a: torch.Tensor, b: torch.Tensor):
    """(a - b) mod 2^(16k) on normalised digits, and the final borrow (bool).

    Borrow passes until no digit is negative: a negative digit takes 2^16
    and passes -1 up; what passes out of the top digit is the borrow."""
    t = a - b
    borrow = torch.zeros(t.shape[:-1], dtype=torch.bool, device=t.device)
    while True:
        neg = t < 0
        with phase("wait/borrow_test"):
            done = not bool(neg.any())
        if done:
            return t, borrow
        borrow |= neg[..., -1]
        negi = neg.to(t.dtype)
        t += negi << LIMB_BITS
        t[..., 1:] -= negi[..., :-1]


def mul_cols(a: torch.Tensor, b: torch.Tensor, top: int) -> torch.Tensor:
    """Schoolbook column sums of a (..., La) times b (..., Lb), int64, the
    first ``top`` columns; each column < min(La, Lb) * 2^32.

    The anti-diagonal sums come from one outer product written into a zero
    buffer with row stride La + Lb: read back with row stride La + Lb - 1,
    row i lands shifted right by i, and a sum over rows gives the columns."""
    batch = a.shape[:-1]
    if b.shape[:-1] != batch:  # torch.broadcast_shapes costs ~0.6 ms a call
        batch = torch.broadcast_shapes(batch, b.shape[:-1])
    La, Lb = a.shape[-1], b.shape[-1]
    w = La + Lb
    a = a.expand(batch + (La,)).reshape(-1, La, 1)
    b = b.expand(batch + (Lb,)).reshape(-1, 1, Lb)
    N = a.shape[0]
    Z = a.new_zeros((N, La * (w - 1)))
    torch.mul(a, b, out=Z.as_strided((N, La, Lb), (La * (w - 1), w, 1)))
    cols = Z.view(N, La, w - 1).sum(dim=1).reshape(batch + (w - 1,))
    return _fit(cols, top) if top > w - 1 else cols[..., :top]


@functools.lru_cache(maxsize=64)
def _toeplitz(digits: tuple, la: int, top: int, device: str) -> torch.Tensor:
    T = np.zeros((la, top + len(digits)), np.float64)
    for i in range(la):
        T[i, i : i + len(digits)] = digits
    return torch.as_tensor(T[:, :top], device=device)


def mul_cols_const(a: torch.Tensor, digits, top: int) -> torch.Tensor:
    """Column sums of a (..., La) int64 times a constant digit vector, the
    first ``top`` columns: one float64 product with the constant's Toeplitz
    matrix, exact because every column is below La * 2^32 < 2^53."""
    T = _toeplitz(tuple(int(d) for d in digits), a.shape[-1], top, str(a.device))
    return (a.to(torch.float64) @ T).to(torch.int64)


@functools.lru_cache(maxsize=64)
def _const(values: tuple, device: str) -> torch.Tensor:
    return torch.as_tensor(values, dtype=torch.int64, device=device)


def const_tensor(values, device) -> torch.Tensor:
    """A digit vector (numpy or list) as an int64 tensor on ``device``
    (cached: callers must not write to it)."""
    return _const(tuple(int(v) for v in values), str(torch.device(device)))


def add_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a + b) mod p on canonical int64 half-limbs."""
    L = spec.n_limbs
    p = const_tensor(list(spec.p_limbs) + [0], a.device)
    s = normalize(a + b, L + 1)
    d, borrow = sub_borrow(s, p)
    return torch.where(borrow.unsqueeze(-1), s, d)[..., :L]


def sub_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """(a - b) mod p on canonical int64 half-limbs."""
    d, borrow = sub_borrow(a, b)
    wrapped = normalize(d + const_tensor(spec.p_limbs, a.device), spec.n_limbs)
    return torch.where(borrow.unsqueeze(-1), wrapped, d)
