"""K5: stages of the constant-geometry (Pease) NTT, and their plain versions.

Replaces ``tpu_ec/ops/pallas/ntt.py::_butterfly_call`` with the stage work
around it in ``PallasFftKernel`` (``_stage_twiddles``, the interleave) and,
with ``bitrev=True``, the bit-reversal gather after the last stage.  The
kernel is ``csrc/ntt.cu``.  Stage s maps the halves (a, b) of every row to
the interleave [u0, v0, u1, v1, ...] with u = a + b, v = (a - b) * w^e,
e = (i >> s) << s, w^e read from the master table w^j (j < n/2).

:func:`pease_stages` runs a range of stages in one launch where a block
holds whole rows (every row of 2^9 points and less, the staged NTT's
sizes); longer rows take one launch a stage.  :func:`pease_stage` is the
one-stage case.
"""

from __future__ import annotations

import torch

from ..fields.limbs import add_plain, sub_plain
from ..fields.params import FieldSpec
from .build import Launches, aligned, check, check_cuda, field_consts, load, stream
from .mont import mont_mul_plain

LAUNCHES = Launches("pease_stage")  # every K5 launch, from either entry


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


def bit_reverse_index(log_n: int, device) -> torch.Tensor:
    """(2^log_n,) int64 index reversing log_n-bit indices."""
    i = torch.arange(1 << log_n, device=device)
    rev = torch.zeros_like(i)
    for b in range(log_n):
        rev |= ((i >> b) & 1) << (log_n - 1 - b)
    return rev


def pease_stages_plain(spec: FieldSpec, y: torch.Tensor, tw: torch.Tensor, s0: int, s1: int,
                       bitrev: bool = False) -> torch.Tensor:
    """Plain PyTorch version on any device: stages s0 .. s1-1 of
    :func:`pease_stage_plain`, then the bit-reversal gather along axis -2
    where ``bitrev`` is set."""
    for s in range(s0, s1):
        y = pease_stage_plain(spec, y, tw, s)
    if bitrev:
        y = y.index_select(-2, bit_reverse_index(y.shape[-2].bit_length() - 1, y.device))
    return y


def pease_stages(spec: FieldSpec, y: torch.Tensor, tw: torch.Tensor, s0: int, s1: int,
                 bitrev: bool = False) -> torch.Tensor:
    """Stages s0 .. s1-1 (0 <= s0 < s1 <= log n) of the Pease NTT over
    every row of ``y`` (..., n, L), natural order out where ``bitrev`` is set.

    CPU tensors take the plain version.  On CUDA, ``y`` and ``tw`` are
    contiguous int32; one launch covers the whole batch and every stage
    where a block holds a whole row, else one launch a stage."""
    L = spec.n_limbs
    n = y.shape[-2] if y.dim() >= 2 else 0
    log_n = n.bit_length() - 1
    if y.shape[-1] != L or n < 2 or 1 << log_n != n or not 0 <= s0 < s1 <= log_n:
        raise ValueError(f"pease_stages: bad shape {tuple(y.shape)} or stages {s0}..{s1 - 1}")
    if y.device.type == "cpu":
        return pease_stages_plain(spec, y, tw, s0, s1, bitrev)
    check_cuda(y, "y", torch.int32)
    check_cuda(tw, "tw", torch.int32, (n // 2, L))
    y, tw = aligned(y), aligned(tw)
    batch = y.numel() // (n * L)
    out = torch.empty_like(y)
    lib = load()
    fc, st = field_consts(spec), stream()
    if lib.tec_pease_rows_fit(L // 2, log_n):
        err = lib.tec_pease_rows(L // 2, y.data_ptr(), tw.data_ptr(), out.data_ptr(), batch, log_n,
                                 s0, s1, int(bitrev), fc, st)
        check(lib, err, "pease_stages")
        LAUNCHES.count += 1
        return out
    # one launch a stage between out and a scratch buffer, the last into out
    bufs = (out, torch.empty_like(y) if s1 - s0 > 1 else None)
    src = y
    for s in range(s0, s1):
        dst = bufs[(s1 - 1 - s) % 2]
        last = int(bitrev and s == s1 - 1)
        err = lib.tec_pease_stage(L // 2, src.data_ptr(), tw.data_ptr(), dst.data_ptr(), batch, log_n,
                                  s, last, fc, st)
        check(lib, err, "pease_stages")
        LAUNCHES.count += 1
        src = dst
    return out


def pease_stage(spec: FieldSpec, y: torch.Tensor, tw: torch.Tensor, s: int) -> torch.Tensor:
    """Stage s of the Pease NTT over every row of ``y`` (..., n, L): the
    one-stage case of :func:`pease_stages`."""
    return pease_stages(spec, y, tw, s, s + 1)

