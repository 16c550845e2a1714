"""K1: the Montgomery product a*b*R^-1 mod p, and its plain version.

Replaces ``tpu_ec/ops/pallas/mont.py::_mont_mul_call`` / ``_mont_mul_call_list``
(entry ``mont_mul_planes``).  The kernel is ``csrc/mont.cu``.  On a CPU
tensor :func:`mont_mul` runs :func:`mont_mul_plain`; on a CUDA tensor it
launches the kernel or raises.
"""

from __future__ import annotations

import torch

from ..fields.limbs import const_tensor, mul_cols, mul_cols_const, normalize, sub_borrow
from ..fields.params import FieldSpec
from .build import Launches, check, check_cuda, field_consts, load, stream

LAUNCHES = Launches("mont_mul")
_LO21 = (1 << 21) - 1


def mont_mul_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch Montgomery product of (..., L) half-limb tensors on any
    device; ``b`` broadcasts against ``a``.  Separated (SOS) reduction with
    the full-width n' = -p^-1 mod R, as tpu_ec/fields/fp.py::FieldOps.mul.
    Inputs canonical (< p); the result is canonical, in ``a``'s dtype."""
    L = spec.n_limbs
    a64 = a.to(torch.int64)
    b64 = b.to(torch.int64)
    t = mul_cols(a64, b64, 2 * L)  # columns of a*b
    # m = (ab mod R) n' mod R from the low columns of t as they are (each
    # < L 2^32), cut at bit 21 so that both float64 products stay exact
    lo = t[..., :L]
    m_cols = mul_cols_const(lo & _LO21, spec.nprime_limbs, L) + (mul_cols_const(lo >> 21, spec.nprime_limbs, L) << 21)
    m = normalize(m_cols, L)
    u = normalize(t + mul_cols_const(m, spec.p_limbs, 2 * L), 2 * L + 1)  # ab + mp, R | u
    hi, top = u[..., L : 2 * L], u[..., 2 * L]
    d, borrow = sub_borrow(hi, const_tensor(spec.p_limbs, a.device))
    take = (top != 0) | ~borrow
    return torch.where(take.unsqueeze(-1), d, hi).to(a.dtype)


def mont_mul(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, *, out: torch.Tensor | None = None) -> torch.Tensor:
    """a*b*R^-1 mod p for (..., L) ``a`` and a ``b`` of a's shape, of its
    trailing shape (the same rows for every leading index, as a twiddle
    table's doubling multiplies each row block by one row of powers), or (L,).

    CPU tensors take the plain version.  CUDA tensors must be contiguous
    int32; the kernel computes it on the current stream, into ``out`` (a
    contiguous tensor of a's shape) where one is given."""
    if a.device.type == "cpu":
        r = mont_mul_plain(spec, a, b)
        return r if out is None else out.copy_(r)
    L = spec.n_limbs
    check_cuda(a, "a", torch.int32)
    if a.shape[-1] != L:
        raise ValueError(f"a: last axis must be {L} half-limbs, got {tuple(a.shape)}")
    if b.dim() > a.dim() or tuple(b.shape) != tuple(a.shape[a.dim() - b.dim():]):
        raise ValueError(f"b: shape {tuple(b.shape)} is not a trailing shape of a's {tuple(a.shape)}")
    check_cuda(b, "b", torch.int32)
    if out is None:
        out = torch.empty_like(a)
    else:
        check_cuda(out, "out", torch.int32, a.shape)
    lib = load()
    err = lib.tec_mont_mul(
        L // 2, a.data_ptr(), b.data_ptr(), out.data_ptr(), a.numel() // L, b.numel() // L,
        field_consts(spec), stream(),
    )
    check(lib, err, "mont_mul")
    LAUNCHES.count += 1
    return out
