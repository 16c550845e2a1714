"""K4: the fused NTT's leaf, a whole 2^R-point NTT per column, and its plain version.

Replaces ``tpu_ec/ops/pallas/ntt_fused.py::_leaf_call`` / ``_leaf_call_list``
together with the bit-reversal gather of ``_leaf_apply``.  The kernel is
``csrc/ntt.cu``.  Stage s of the decimation-in-frequency leaf splits a
column into 2^s blocks and butterflies each block's halves in place with
the stage twiddle ``tw[s, j]`` (pair j of its block: W_m^(j 2^s), the same
in every block); the output is bit-reversed, and both versions return it in
natural order.
"""

from __future__ import annotations

import torch

from ..fields.limbs import add_plain, sub_plain
from ..fields.params import FieldSpec
from .build import Launches, check, check_cuda, field_consts, load, stream
from .mont import mont_mul_plain

LAUNCHES = Launches("ntt_leaf")
MAX_LEAF_LOG = 10  # a column in shared memory: 2^10 * 48 B at most


def ntt_leaf_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version on any device: ``x`` (m, B, L) columns along
    axis 0, ``tw`` (R, m/2, L) stage twiddles; returns (m, B, L) in ``x``'s
    dtype, natural order."""
    m = x.shape[0]
    log_m = m.bit_length() - 1
    v = x.to(torch.int64)
    t = tw.to(torch.int64)
    for s in range(log_m):
        q = m >> (s + 1)
        v4 = v.reshape((1 << s, 2, q) + tuple(v.shape[1:]))
        a, b = v4[:, 0], v4[:, 1]
        w = t[s, :q].reshape((q,) + (1,) * (v.dim() - 2) + (t.shape[-1],))  # block-independent
        u = add_plain(spec, a, b)
        d = mont_mul_plain(spec, sub_plain(spec, a, b), w)
        v = torch.stack([u, d], dim=1).reshape(v.shape)
    i = torch.arange(m, device=x.device)
    rev = torch.zeros_like(i)
    for b in range(log_m):  # the bit reversal the kernel does with __brev
        rev |= ((i >> b) & 1) << (log_m - 1 - b)
    return v[rev].to(x.dtype)


def ntt_leaf(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """The 2^R-point NTT of every column of ``x`` (m = 2^R, B, L).

    CPU tensors take the plain version.  On CUDA, ``x`` and ``tw`` are
    contiguous int32 and 1 <= R <= MAX_LEAF_LOG; one thread block per
    column (several for small leaves)."""
    if x.device.type == "cpu":
        return ntt_leaf_plain(spec, x, tw)
    L = spec.n_limbs
    check_cuda(x, "x", torch.int32)
    m = x.shape[0]
    log_m = m.bit_length() - 1
    if x.dim() != 3 or x.shape[2] != L or 1 << log_m != m or not 1 <= log_m <= MAX_LEAF_LOG:
        raise ValueError(f"ntt_leaf: expected (2^R, B, {L}) with 1 <= R <= {MAX_LEAF_LOG}, "
                         f"got {tuple(x.shape)}")
    check_cuda(tw, "tw", torch.int32, (log_m, m // 2, L))
    out = torch.empty_like(x)
    lib = load()
    err = lib.tec_ntt_leaf(
        L // 2, x.data_ptr(), tw.data_ptr(), out.data_ptr(), log_m, x.shape[1],
        field_consts(spec), stream(),
    )
    check(lib, err, "ntt_leaf")
    LAUNCHES.count += 1
    return out
