"""Vectorised numpy Montgomery product for host-side table construction.

The domain twiddle and Bailey tables are built once per domain on the host
(``ops/ntt.py``, ``ops/ntt_digit.py``).  numpy has uint64 headroom, so the
16x16-bit products need no lo/hi split: column sums stay below L * 2^32.
Same algebra and same results as ``tpu_ec/fields/bigint.py::np_mont_mul``.
"""

from __future__ import annotations

import numpy as np

from .params import LIMB_BITS, LIMB_MASK, FieldSpec


def _np_mul_cols(a: np.ndarray, b: np.ndarray, L: int) -> np.ndarray:
    """(n, L) x (n, L) uint64 (entries < 2^16) -> (n, 2L) column sums via the
    anti-diagonal reshape trick of limbs.mul_cols (padded row stride)."""
    n = a.shape[0]
    P = a[:, :, None] * b[:, None, :]  # (n, L, L) uint64
    F = np.pad(P, ((0, 0), (0, 0), (0, L + 1)))  # rows width 2L+1
    flat = F.reshape(n, L * (2 * L + 1))
    G = flat[:, : L * 2 * L].reshape(n, L, 2 * L)
    return G.sum(axis=1)  # (n, 2L)


def _np_normalize(cols: np.ndarray):
    """Exact base-2^16 digits (serial ripple; vectorized over the batch)."""
    out = np.zeros_like(cols)
    c = np.zeros(cols.shape[0], np.uint64)
    for i in range(cols.shape[1]):
        v = cols[:, i] + c
        out[:, i] = v & LIMB_MASK
        c = v >> LIMB_BITS
    return out, c


def _np_cond_sub_p(t: np.ndarray, p_limbs: np.ndarray) -> np.ndarray:
    d = np.zeros_like(t)
    borrow = np.zeros(t.shape[0], np.uint64)
    for i in range(t.shape[1]):
        v = t[:, i] + (1 << LIMB_BITS) - p_limbs[i] - borrow
        d[:, i] = v & LIMB_MASK
        borrow = 1 - (v >> LIMB_BITS)
    return np.where((borrow == 0)[:, None], d, t)


def np_mont_mul(spec: FieldSpec, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Batch Montgomery product of (n, L) uint32/uint64 limb arrays —
    numpy mirror of fp.FieldOps.mul (same SOS algebra, same results)."""
    L = spec.n_limbs
    a = np.ascontiguousarray(a, np.uint64)
    b = np.broadcast_to(np.asarray(b, np.uint64), a.shape)
    npr = np.asarray(spec.nprime_limbs, np.uint64)
    p = np.asarray(spec.p_limbs, np.uint64)
    t = _np_mul_cols(a, b, L)
    t_lo, c_lo = _np_normalize(t[:, :L])
    m, _ = _np_normalize(
        _np_mul_cols(t_lo, np.broadcast_to(npr, t_lo.shape), L)[:, :L]
    )
    mp = _np_mul_cols(m, np.broadcast_to(p, m.shape), L)
    u_hi = t[:, L:] + mp[:, L:]
    u_hi[:, 0] += c_lo
    u = np.concatenate([t_lo + mp[:, :L], u_hi], axis=1)
    un, _ = _np_normalize(u)
    return _np_cond_sub_p(un[:, L:], p).astype(np.uint32)
