"""K6 (co-Z pair add) and K7 (batch-affine pair add: denominators, then
apply), and their plain versions.

Replaces ``tpu_ec/ops/pallas/affine.py::_coz_apply_call`` (K6),
``_denom_call`` and ``_apply_call`` (K7).  The kernels are
``csrc/affine.cu``.  Points are affine (x, y) coordinates, (0, 0) = the
identity.  Every function reproduces ``affine.py::_flags`` and the select
order of its kernel, so the outputs are bit-identical to tpu_ec's.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.limbs import add_plain, const_tensor, sub_plain
from ..fields.params import FieldSpec
from .build import Launches, check, field_consts, load, row_views, stream
from .mont import mont_mul_plain

DENOM_LAUNCHES = Launches("affine_denom")
APPLY_LAUNCHES = Launches("affine_apply")
COZ_LAUNCHES = Launches("coz_apply")

_DENOM, _APPLY, _COZ = 0, 1, 2


def _flags(x1, y1, x2, y2):
    """(iz1, iz2, same, cancel) per row, as ``affine.py::_flags``: same =
    both finite and equal with y != 0 (tangent); cancel = both finite, x
    equal and y different, or the order-2 tangent y1 == 0."""
    zero = lambda a: (a == 0).all(dim=-1)
    iz1 = zero(x1) & zero(y1)
    iz2 = zero(x2) & zero(y2)
    xeq = (x1 == x2).all(dim=-1)
    yeq = (y1 == y2).all(dim=-1)
    y1z = zero(y1)
    finite = ~iz1 & ~iz2
    return iz1, iz2, finite & xeq & yeq & ~y1z, finite & xeq & (~yeq | y1z)


def _where(cond, a, b):
    return torch.where(cond.unsqueeze(-1), a, b)


def _numerator(spec, x1, y1, y2, same):
    """3 * x1^2 (tangent, a = 0) where ``same``, else y2 - y1 (chord)."""
    x1sq = mont_mul_plain(spec, x1, x1)
    three = add_plain(spec, add_plain(spec, x1sq, x1sq), x1sq)
    return _where(same, three, sub_plain(spec, y2, y1))


def affine_denom_plain(spec: FieldSpec, x1, y1, x2, y2) -> torch.Tensor:
    """Plain version of the K7 denominator on any device: 2*y1 for P == Q,
    x2 - x1 otherwise, Montgomery one for degenerate rows."""
    dt = x1.dtype
    x1, y1, x2, y2 = (c.to(torch.int64) for c in (x1, y1, x2, y2))
    iz1, iz2, same, cancel = _flags(x1, y1, x2, y2)
    d = _where(same, add_plain(spec, y1, y1), sub_plain(spec, x2, x1))
    one = const_tensor(spec.one_limbs, x1.device).expand_as(d)
    return _where(iz1 | iz2 | cancel, one, d).to(dt)


def affine_apply_plain(spec: FieldSpec, x1, y1, x2, y2, iv) -> tuple:
    """Plain version of the K7 apply on any device: (x3, y3) from the
    inverted denominators ``iv``."""
    dt = x1.dtype
    x1, y1, x2, y2, iv = (c.to(torch.int64) for c in (x1, y1, x2, y2, iv))
    iz1, iz2, same, cancel = _flags(x1, y1, x2, y2)
    lam = mont_mul_plain(spec, _numerator(spec, x1, y1, y2, same), iv)
    x3 = sub_plain(spec, sub_plain(spec, mont_mul_plain(spec, lam, lam), x1), x2)
    y3 = sub_plain(spec, mont_mul_plain(spec, lam, sub_plain(spec, x1, x3)), y1)
    out = []
    for r, a, b in ((x3, x1, x2), (y3, y1, y2)):
        r = _where(cancel, torch.zeros_like(r), r)
        r = _where(iz2, a, r)
        out.append(_where(iz1, b, r).to(dt))
    return tuple(out)


def coz_apply_plain(spec: FieldSpec, x1, y1, x2, y2, pp, r2, r3) -> tuple:
    """Plain version of K6 on any device.  Coordinates (..., s, L); ``r2``,
    ``r3`` (..., 1, L) broadcast over the rows of each window."""
    dt = x1.dtype
    x1, y1, x2, y2, pp, r2, r3 = (c.to(torch.int64) for c in (x1, y1, x2, y2, pp, r2, r3))
    iz1, iz2, same, cancel = _flags(x1, y1, x2, y2)
    t = mont_mul_plain(spec, _numerator(spec, x1, y1, y2, same), pp)
    x1r2 = mont_mul_plain(spec, x1, r2)
    x2r2 = mont_mul_plain(spec, x2, r2)
    y1r3 = mont_mul_plain(spec, y1, r3)
    y2r3 = mont_mul_plain(spec, y2, r3)
    x3 = sub_plain(spec, sub_plain(spec, mont_mul_plain(spec, t, t), x1r2), x2r2)
    y3 = sub_plain(spec, mont_mul_plain(spec, t, sub_plain(spec, x1r2, x3)), y1r3)
    both = iz1 & iz2
    out = []
    for r, a, b in ((x3, x1r2, x2r2), (y3, y1r3, y2r3)):
        zero = torch.zeros_like(r)
        r = _where(cancel, zero, r)
        r = _where(iz2, a, r)
        r = _where(iz1, b, r)
        out.append(_where(both, zero, r).to(dt))
    return tuple(out)


def _launch(spec: FieldSpec, op: int, coords, r2=None, r3=None):
    L = spec.n_limbs
    shape = coords[0].shape
    what = ("affine_denom", "affine_apply", "coz_apply")[op]
    flat = row_views(what, coords, L)
    n = flat[0].shape[0]
    dev = coords[0].device
    outs = [torch.empty((n, L), dtype=torch.int32, device=dev) for _ in range(1 if op == _DENOM else 2)]
    ins = (ctypes.c_void_p * 5)(*[f.data_ptr() for f in flat])
    strides = (ctypes.c_longlong * 5)(*[f.stride(0) for f in flat])
    out_ptrs = (ctypes.c_void_p * 2)(*[o.data_ptr() for o in outs])
    r2p = r3p = None
    rows = 0
    if op == _COZ:
        rows = shape[-2] if len(shape) >= 2 else n
        windows = n // rows if rows else 0
        r2, r3 = (r.reshape(-1, L).contiguous() for r in (r2, r3))
        for name, r in (("r2", r2), ("r3", r3)):
            if r.device != dev or r.dtype != torch.int32 or r.shape[0] != windows:
                raise ValueError(f"coz_apply: {name} must be int32 ({windows}, 1, {L}) on {dev}")
        r2p, r3p = r2.data_ptr(), r3.data_ptr()
    lib = load()
    err = lib.tec_affine(
        op, L // 2, ins, strides, out_ptrs, L, n, r2p, r3p, rows, field_consts(spec), stream()
    )
    check(lib, err, what)
    return tuple(o.reshape(shape) for o in outs)


def affine_denom(spec: FieldSpec, x1, y1, x2, y2) -> torch.Tensor:
    """Inversion denominators of a batch of affine pair adds, (..., L)
    coordinates; degenerate rows get 1, so the batch has no zeros.  CPU
    tensors take the plain version; CUDA int32 tensors launch K7 (denom)."""
    if x1.device.type == "cpu":
        return affine_denom_plain(spec, x1, y1, x2, y2)
    (d,) = _launch(spec, _DENOM, (x1, y1, x2, y2))
    DENOM_LAUNCHES.count += 1
    return d


def affine_apply(spec: FieldSpec, x1, y1, x2, y2, iv) -> tuple:
    """Complete affine add given the inverted denominators ``iv``.  CPU
    tensors take the plain version; CUDA int32 tensors launch K7 (apply)."""
    if x1.device.type == "cpu":
        return affine_apply_plain(spec, x1, y1, x2, y2, iv)
    out = _launch(spec, _APPLY, (x1, y1, x2, y2, iv))
    APPLY_LAUNCHES.count += 1
    return out


def coz_apply(spec: FieldSpec, x1, y1, x2, y2, pp, r2, r3) -> tuple:
    """Co-Z scaled-affine complete pair add (see ``ops/affine.py``).  CPU
    tensors take the plain version; CUDA int32 tensors launch K6, which
    reads r2/r3 by window (the leading axes of the coordinates)."""
    if x1.device.type == "cpu":
        return coz_apply_plain(spec, x1, y1, x2, y2, pp, r2, r3)
    out = _launch(spec, _COZ, (x1, y1, x2, y2, pp), r2, r3)
    COZ_LAUNCHES.count += 1
    return out
