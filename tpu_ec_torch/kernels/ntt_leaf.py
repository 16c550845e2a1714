"""K4: the fused NTT's leaf, a whole 2^R-point NTT per column, and its plain version.

Replaces ``tpu_ec/ops/pallas/ntt_fused.py::_leaf_call`` / ``_leaf_call_list``
together with the bit-reversal gather of ``_leaf_apply``.  The kernel is
``csrc/ntt.cu``.  Stage s of the decimation-in-frequency leaf splits a
column into 2^s blocks and butterflies each block's halves in place with
the stage twiddle ``tw[s, j]`` (pair j of its block: W_m^(j 2^s), the same
in every block); the output is bit-reversed, and both versions return it in
natural order.

With ``level=(T, B)`` the leaf also does the rest of one level of the fused
NTT (``tpu_ec``'s ``_rec``: ``_twiddle_mul`` by the level table, then the
transpose): column c = j1 * B + b of the (m, n1 * B) input, natural row k2,
is multiplied by T[k2, j1] and lands at row j1, column k2 * B + b of the
(n1, m * B) output.
"""

from __future__ import annotations

import torch

from ..fields.limbs import add_plain, sub_plain
from ..fields.params import FieldSpec
from .build import Launches, aligned, check, check_cuda, field_consts, load, stream
from .butterfly import bit_reverse_index
from .mont import mont_mul_plain

LAUNCHES = Launches("ntt_leaf")
LEVEL_LAUNCHES = Launches("ntt_leaf_level")  # the launches with the level epilogue
MAX_LEAF_LOG = 10  # a column in shared memory: 2^10 * 48 B at most


def ntt_leaf_plain(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, level=None) -> torch.Tensor:
    """Plain PyTorch version on any device: ``x`` (m, B, L) columns along
    axis 0, ``tw`` (R, m/2, L) stage twiddles; returns (m, B, L) in ``x``'s
    dtype, natural order.  With ``level=(T, B)``, T (m, n1, L): the leaf's
    output times T, transposed to (n1, m * B, L)."""
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
    v = v[bit_reverse_index(log_m, x.device)]
    if level is not None:
        T, B = level
        n1, L = T.shape[1], T.shape[2]
        T = T[:, :, None, :].expand(m, n1, B, L).reshape(m, n1 * B, L)
        v = mont_mul_plain(spec, v, T.to(torch.int64))
        v = v.reshape(m, n1, B * L).transpose(0, 1).reshape(n1, m * B, L)
    return v.to(x.dtype)


def ntt_leaf(spec: FieldSpec, x: torch.Tensor, tw: torch.Tensor, level=None) -> torch.Tensor:
    """The 2^R-point NTT of every column of ``x`` (m = 2^R, batch, L), and
    with ``level=(T, B)`` its level epilogue (see the module docstring).

    CPU tensors take the plain version.  On CUDA, ``x``, ``tw`` and T are
    contiguous int32 and 1 <= R <= MAX_LEAF_LOG; one thread block holds
    1024 / m adjacent columns (one column from R = 10)."""
    L = spec.n_limbs
    m = x.shape[0]
    log_m = m.bit_length() - 1
    if x.dim() != 3 or x.shape[2] != L or 1 << log_m != m or not 1 <= log_m <= MAX_LEAF_LOG:
        raise ValueError(f"ntt_leaf: expected (2^R, B, {L}) with 1 <= R <= {MAX_LEAF_LOG}, "
                         f"got {tuple(x.shape)}")
    batch = x.shape[1]
    if level is not None:
        T, B = level
        if B < 1 or batch % B or tuple(T.shape) != (m, batch // B, L):
            raise ValueError(f"ntt_leaf: level table {tuple(T.shape)} with B = {B} does not fit "
                             f"{tuple(x.shape)}; expected ({m}, {batch} / B, {L})")
    if x.device.type == "cpu":
        return ntt_leaf_plain(spec, x, tw, level)
    check_cuda(x, "x", torch.int32)
    check_cuda(tw, "tw", torch.int32, (log_m, m // 2, L))
    x, tw = aligned(x), aligned(tw)
    lvl, B, counter = 0, 1, LAUNCHES
    if level is None:
        out = torch.empty_like(x)
    else:
        T, B = level
        check_cuda(T, "T", torch.int32)
        T = aligned(T)
        lvl, counter = T.data_ptr(), LEVEL_LAUNCHES
        out = torch.empty((batch // B, m * B, L), dtype=x.dtype, device=x.device)
    lib = load()
    err = lib.tec_ntt_leaf(
        L // 2, x.data_ptr(), tw.data_ptr(), lvl, out.data_ptr(), log_m, batch, B,
        field_consts(spec), stream(),
    )
    check(lib, err, "ntt_leaf")
    counter.count += 1
    return out
