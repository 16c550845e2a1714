"""K5: one stage of the constant-geometry (Pease) NTT, and its plain version.

Replaces ``tpu_ec/ops/pallas/ntt.py::_butterfly_call`` with the stage work
around it in ``PallasFftKernel`` (``_stage_twiddles``, the interleave).  The
kernel is ``csrc/ntt.cu``.  Stage s maps the halves (a, b) of every row to
the interleave [u0, v0, u1, v1, ...] with u = a + b, v = (a - b) * w^e,
e = (i >> s) << s, w^e read from the master table w^j (j < n/2).
"""

from __future__ import annotations

import torch

from ..fields.limbs import add_plain, sub_plain
from ..fields.params import FieldSpec
from .build import Launches, check, check_cuda, field_consts, load, stream
from .mont import mont_mul_plain

LAUNCHES = Launches("pease_stage")


def pease_stage_plain(spec: FieldSpec, y: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """Plain PyTorch version on any device: ``y`` (..., n, L), ``tw`` the
    (n/2, L) master table; returns stage s's output in ``y``'s dtype."""
    half = y.shape[-2] // 2
    a = y[..., :half, :].to(torch.int64)
    b = y[..., half:, :].to(torch.int64)
    idx = (torch.arange(half, device=y.device) >> s) << s
    u = add_plain(spec, a, b)
    v = mont_mul_plain(spec, sub_plain(spec, a, b), tw[idx].to(torch.int64))
    return torch.stack([u, v], dim=-2).reshape(y.shape).to(y.dtype)


def pease_stage(spec: FieldSpec, y: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """Stage s of the Pease NTT over every row of ``y`` (..., n, L).

    CPU tensors take the plain version.  On CUDA, ``y`` and ``tw`` are
    contiguous int32; one launch covers the whole batch."""
    if y.device.type == "cpu":
        return pease_stage_plain(spec, y, tw, s)
    L = spec.n_limbs
    check_cuda(y, "y", torch.int32)
    n = y.shape[-2] if y.dim() >= 2 else 0
    log_n = n.bit_length() - 1
    if y.shape[-1] != L or n < 2 or 1 << log_n != n or not 0 <= s < log_n:
        raise ValueError(f"pease_stage: bad shape {tuple(y.shape)} or stage {s}")
    check_cuda(tw, "tw", torch.int32, (n // 2, L))
    out = torch.empty_like(y)
    lib = load()
    err = lib.tec_pease_stage(
        L // 2, y.data_ptr(), tw.data_ptr(), out.data_ptr(), y.numel() // (n * L), log_n, s,
        field_consts(spec), stream(),
    )
    check(lib, err, "pease_stage")
    LAUNCHES.count += 1
    return out
