"""K2: the digit-NTT inter-level twiddle, and its plain version.

Replaces ``tpu_ec/ops/ntt_digit.py::_inter_call`` (entry ``inter_twiddle``),
both of its inputs.  The kernel is ``csrc/inter.cu``.  One pass per column:
raw int32 GEMM columns, or 37 int8 base-2^7 digits (``_inter_call``'s
``in_i8``, counted apart), -> the value v < 2^288 -> u = v * T' / 2^288
(Montgomery with R' = 2^288, T' = twiddle * 2^288 mod p, so u = v * twiddle
mod p up to a multiple of p, u < 2p) -> 37 int8 base-2^7 digits of u, or
with ``canonical`` u mod p as 16 half-limbs.

The twiddle of column i is row ``i // t_rep`` of an (nt, 16) table, the
layout K1 writes: a four-step level over a batch of M columns passes its
(n2 * n1, 16) table with ``t_rep = M`` instead of a broadcast copy of
n2 * n1 * M rows.  ``const_t`` takes one (16,) twiddle for every column.
"""

from __future__ import annotations

import torch

from ..fields.limbs import LIMB_BITS, const_tensor, mul_cols, mul_cols_const, normalize, sub_borrow
from ..fields.params import FieldSpec, int_to_limbs
from .build import Launches, check, check_cuda, field_consts, load, stream

LAUNCHES = Launches("inter_twiddle")
LAUNCHES_I8 = Launches("inter_twiddle_i8")

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1
WIDE_LIMBS = 18  # R' = 2^(16*18) = 2^288
OUT_DIGITS = 37  # ceil(256 / 7)


def _twiddle_rows(t16: torch.Tensor, n: int, const_t: bool, t_rep: int) -> torch.Tensor:
    """The twiddle of every column as (n, 16) int64 (a (1, 16) row when
    ``const_t``); raises unless the table's rows times ``t_rep`` are n."""
    t = t16.to(torch.int64)
    if const_t:
        return t.unsqueeze(0)
    if t.shape[0] * t_rep != n:
        raise ValueError(f"t16: {t.shape[0]} twiddle rows x t_rep {t_rep} != {n} columns")
    return t.repeat_interleave(t_rep, dim=0) if t_rep > 1 else t


def inter_twiddle_plain(
    spec: FieldSpec, cols: torch.Tensor, t16: torch.Tensor, *,
    canonical: bool = False, const_t: bool = False, t_rep: int = 1, out_rows: bool = False,
) -> torch.Tensor:
    """Plain PyTorch version on any device.  ``cols`` (dc, n) int32 columns
    in [0, 2^31) or int8 digits in [0, 128); ``t16`` (nt, 16) half-limb
    rows, row ``i // t_rep`` serving column i, or (16,) with ``const_t``.
    Returns (37, n) int8 digits, or (16, n) canonical half-limbs ((n, 16)
    with ``out_rows``) in the storage dtype of ``t16``."""
    dc, n = cols.shape
    dev = cols.device
    L16 = spec.n_limbs
    # v = sum_e cols[e] 2^(7e) mod 2^288: column e shifted by 7e % 16 spans
    # three 16-bit limbs from limb 7e // 16; each part is < 2^16
    e = torch.arange(dc, device=dev)
    off = (e * DIGIT_BITS) % LIMB_BITS
    i0 = (e * DIGIT_BITS) // LIMB_BITS
    x = cols.to(torch.int64).T << off  # (n, dc), < 2^46
    acc = torch.zeros((n, WIDE_LIMBS + 3), dtype=torch.int64, device=dev)
    acc.index_add_(1, i0, x & 0xFFFF)
    acc.index_add_(1, i0 + 1, (x >> 16) & 0xFFFF)
    acc.index_add_(1, i0 + 2, x >> 32)
    v = normalize(acc, WIDE_LIMBS)
    t = _twiddle_rows(t16, n, const_t, t_rep)
    R = 1 << (LIMB_BITS * WIDE_LIMBS)
    npr = int_to_limbs((-pow(spec.modulus, -1, R)) % R, WIDE_LIMBS)
    top = WIDE_LIMBS + L16
    tc = mul_cols(v, t, top)
    m = normalize(mul_cols_const(normalize(tc, WIDE_LIMBS), npr, WIDE_LIMBS), WIDE_LIMBS)
    u = normalize(tc + mul_cols_const(m, spec.p_limbs, top), top + 1)[:, WIDE_LIMBS:top]  # < 2p
    if canonical:
        d, borrow = sub_borrow(u, const_tensor(spec.p_limbs, dev))
        r = torch.where(borrow.unsqueeze(-1), u, d)
        return (r if out_rows else r.T).contiguous().to(t16.dtype)
    digits = []
    for k in range(OUT_DIGITS):
        j, s = divmod(k * DIGIT_BITS, LIMB_BITS)
        d = u[:, j] >> s
        if s > LIMB_BITS - DIGIT_BITS and j + 1 < L16:
            d = d | (u[:, j + 1] << (LIMB_BITS - s))
        digits.append(d & DIGIT_MASK)
    return torch.stack(digits, dim=0).to(torch.int8)


def inter_twiddle(
    spec: FieldSpec, cols: torch.Tensor, t16: torch.Tensor, *,
    canonical: bool = False, const_t: bool = False, t_rep: int = 1, out_rows: bool = False,
) -> torch.Tensor:
    """One fused carry -> pack -> wide-Montgomery -> split pass.

    CPU tensors take the plain version.  On CUDA, ``cols`` is contiguous
    (dc, n) int32, or int8 digits (the int8 entry, counted apart), and
    ``t16`` contiguous int32; the kernel computes it."""
    if out_rows and not canonical:
        raise ValueError("out_rows: only the canonical output has a row layout")
    if cols.device.type == "cpu":
        return inter_twiddle_plain(spec, cols, t16, canonical=canonical, const_t=const_t, t_rep=t_rep,
                                   out_rows=out_rows)
    if spec.n_limbs != 16:
        raise ValueError("inter_twiddle takes 256-bit fields (16 half-limbs)")
    in_i8 = cols.dtype == torch.int8
    check_cuda(cols, "cols", torch.int8 if in_i8 else torch.int32)
    if cols.dim() != 2:
        raise ValueError(f"cols: expected (dc, n), got {tuple(cols.shape)}")
    dc, n = cols.shape
    if t_rep < 1 or n % t_rep:
        raise ValueError(f"t_rep {t_rep} does not divide {n} columns")
    check_cuda(t16, "t16", torch.int32, (16,) if const_t else (n // t_rep, 16))
    if canonical:
        out = torch.empty((n, 16) if out_rows else (16, n), dtype=torch.int32, device=cols.device)
    else:
        out = torch.empty((OUT_DIGITS, n), dtype=torch.int8, device=cols.device)
    lib = load()
    err = lib.tec_inter(
        cols.data_ptr(), dc, int(in_i8), t16.data_ptr(), int(const_t), t_rep, out.data_ptr(), int(canonical),
        int(out_rows), n, field_consts(spec), stream(),
    )
    check(lib, err, "inter_twiddle")
    (LAUNCHES_I8 if in_i8 else LAUNCHES).count += 1
    return out
