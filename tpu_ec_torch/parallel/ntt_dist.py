"""The distributed NTT: one transform split across the mesh, four-step.

PyTorch counterpart of ``tpu_ec/parallel/ntt_dist.py``.  The reference
cannot split one FFT across devices (``ec-gpu-proxy/src/fft.rs:211-246``
only deals whole transforms out); here one length-n NTT is sharded with
the four-step scheme, n = n1 n2 and the input x viewed as A[j1, j2]
(j = j1 n2 + j2):

  1. column DFTs of length n1 (root w^n2)   -- local after exchange 1
  2. twiddle multiply by w^(k1 j2) (K1)     -- local, this rank's columns
  3. row DFTs of length n2 (root w^n1)      -- local after exchange 2
  4. X[k1 + n1 k2] = Z[k1, k2]               -- natural order after exchange 3

Each exchange is one ``all_to_all_single`` (tpu_ec's tiled
``lax.all_to_all``): the split axis is brought to the front and made
contiguous, and the chunks received are concatenated along the concat axis
in source-rank order.  The local DFTs are batched transforms on the
single-card kernels: the digit route (``ops/ntt_digit.py``
``digit_ntt_planes_batch``: int8 leaf GEMMs, K2) where config ``ntt_impl``
is "digit" and both factors are at least 2^DIGIT_LOCAL_MIN_LOG, else the
Pease route (K5 over every column at once).  The digit stages fold n1^-1
and n2^-1 into their last constants; the Pease route scales by n^-1 once
at the end.  Outputs are canonical, bit for bit tpu_ec's.

Each rank passes its contiguous (n/d, L) slab of the natural-order input
and gets back its contiguous (n/d, L) slab of X.  The twiddles are built on
the rank's device with K1 (only its (n1, n2/d) column slice), where tpu_ec
builds the whole (n1, n2) table in numpy and shards it.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist

from ..config import get_config
from ..fields.fp import FieldOps
from ..fields.limbs import storage_dtype
from ..fields.params import FieldSpec, int_to_limbs
from ..kernels.butterfly import pease_stages
from ..kernels.mont import mont_mul
from ..ops.ntt import get_domain
from ..ops.ntt_digit import digit_consts, digit_ntt_planes_batch, get_digit_domain, leaf_log
from .mesh import Mesh

# the local DFTs run on the digit route where both factors are at least
# 2^DIGIT_LOCAL_MIN_LOG (tpu_ec's min(log_n1, log_n2) > 9)
DIGIT_LOCAL_MIN_LOG = 10


def exchange(x: torch.Tensor, mesh: Mesh, split_axis: int, concat_axis: int) -> torch.Tensor:
    """tpu_ec's ``lax.all_to_all(x, split_axis, concat_axis, tiled=True)``
    over the mesh: x split into d chunks along ``split_axis``, chunk j sent
    to rank j, and the d chunks received concatenated along
    ``concat_axis`` in source-rank order."""
    d = mesh.size
    shape = list(x.shape)
    m = shape[split_axis] // d
    parts = x.reshape(shape[:split_axis] + [d, m] + shape[split_axis + 1 :])
    send = parts.movedim(split_axis, 0).contiguous()  # (d, ..., m, ...): chunk j first
    recv = torch.empty_like(send)
    dist.all_to_all_single(recv, send, group=mesh.group)
    del send
    piece = shape[:split_axis] + [m] + shape[split_axis + 1 :]
    recv = recv.reshape([d] + piece)
    out = recv.movedim(0, concat_axis)  # (..., d, piece's axis ...)
    piece[concat_axis] *= d
    return out.reshape(piece)


def twiddle_slice(spec: FieldSpec, log_n: int, inverse: bool, rank: int, d: int, device) -> torch.Tensor:
    """This rank's (n1, n2/d, L) column slice of the four-step twiddles
    T[k1, j2] = w^(k1 j2) in Montgomery form, j2 in [rank n2/d, (rank + 1)
    n2/d) (tpu_ec's ``DistDomain.twiddles`` columns), built on ``device``
    with K1: the row w^j2 of this rank's columns by doubling from w^j0
    (log2(n2/d) launches), then rows [2^t, 2^(t+1)) = rows [0, 2^t) times
    w^(2^t j2) (log2(n1) launches, and log2(n1) - 1 squarings)."""
    L, p = spec.n_limbs, spec.modulus
    log_n1 = log_n // 2
    n1, cols = 1 << log_n1, (1 << (log_n - log_n1)) // d
    omega = pow(spec.root_of_unity, 1 << (spec.two_adicity - log_n), p)
    if inverse:
        omega = pow(omega, p - 2, p)
    dtype = storage_dtype(device)

    def limbs(v: int) -> torch.Tensor:
        return torch.as_tensor(int_to_limbs(spec.to_mont(v), L).astype(np.int64)).to(device, dtype)

    step = torch.empty((cols, L), dtype=dtype, device=device)
    step[0] = limbs(pow(omega, rank * cols, p))
    r, w_r = 1, omega
    while r < cols:
        mont_mul(spec, step[:r], limbs(w_r), out=step[r : 2 * r])
        w_r = w_r * w_r % p
        r *= 2
    table = torch.empty((n1, cols, L), dtype=dtype, device=device)
    table[0] = limbs(1)
    r = 1
    while r < n1:
        mont_mul(spec, table[:r], step, out=table[r : 2 * r])
        r *= 2
        if r < n1:
            step = mont_mul(spec, step, step)
    return table


def use_digit_local(log_n1: int, log_n2: int) -> bool:
    """The local DFTs take the digit route: config ``ntt_impl`` "digit" and
    both factors at least 2^DIGIT_LOCAL_MIN_LOG (both stages or neither, so
    that the inverse's scale stays in one place)."""
    return get_config().ntt_impl == "digit" and min(log_n1, log_n2) >= DIGIT_LOCAL_MIN_LOG


class _Plan:
    """The tables of one (log_n, direction, route) on one rank: the twiddle
    slice, and the local stages' Pease tables or digit constants."""

    def __init__(self, spec: FieldSpec, log_n: int, inverse: bool, mesh: Mesh, digit: bool):
        d = mesh.size
        log_d = d.bit_length() - 1
        if 1 << log_d != d:
            raise ValueError(f"mesh size must be a power of two, got {d}")
        self.log_n1 = log_n // 2
        self.log_n2 = log_n - self.log_n1
        if min(self.log_n1, self.log_n2) < log_d:
            raise ValueError(f"2^{log_n} too small to factor over {d} devices (need both factors >= {d})")
        self.n1, self.n2, self.n = 1 << self.log_n1, 1 << self.log_n2, 1 << log_n
        self.inverse, self.digit = inverse, digit
        dev = mesh.device
        self.tw = twiddle_slice(spec, log_n, inverse, mesh.rank, d, dev)
        self.stages = []
        for ln in (self.log_n1, self.log_n2):
            if digit:
                leaf = leaf_log(ln)
                self.stages.append((leaf, digit_consts(get_digit_domain(spec, ln, inverse, leaf), dev)))
            else:
                tw = get_domain(spec, ln, inverse).twiddles
                self.stages.append(torch.as_tensor(tw.astype(np.int64)).to(dev, storage_dtype(dev)))
        self.n_inv = FieldOps(spec, dev).constant(pow(self.n, -1, spec.modulus))


class DistFftKernel:
    """The sharded NTT bound to one field and mesh: one length-n transform
    split across the mesh's ranks (the step beyond the reference's
    ``FftKernel::radix_fft_many``, which deals out whole transforms)."""

    def __init__(self, spec: FieldSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh
        self.f = FieldOps(spec, mesh.device)
        self._plans: dict = {}

    def plan(self, log_n: int, inverse: bool) -> _Plan:
        """The tables of a transform of 2^log_n, built on first use and kept
        per (ntt_impl, log_n, direction, route, leaf): the key holds the
        config's route, which tpu_ec's cache omits."""
        cfg = get_config()
        log_n1 = log_n // 2
        digit = use_digit_local(log_n1, log_n - log_n1)
        key = (cfg.ntt_impl, log_n, inverse, digit, cfg.ntt_digit_leaf_log if digit else None)
        if key not in self._plans:
            self._plans[key] = _Plan(self.spec, log_n, inverse, self.mesh, digit)
        return self._plans[key]

    def _local(self, plan: _Plan, stage: int, y: torch.Tensor, axis: int) -> torch.Tensor:
        """Length-m DFTs along ``axis`` (0 or 1) of y (rows, cols, L), the
        other axis the batch; same layout out."""
        if plan.digit:
            leaf, consts = plan.stages[stage]
            planes = y.permute(2, axis, 1 - axis).contiguous()  # (L, m, B)
            del y
            out = digit_ntt_planes_batch(self.spec, planes, plan.inverse, leaf=leaf, consts=consts)
            del planes
            return out.permute(1, 2, 0).contiguous() if axis == 0 else out.permute(2, 1, 0).contiguous()
        log_m = plan.log_n1 if stage == 0 else plan.log_n2
        if log_m == 0:
            return y
        rows = y.transpose(0, 1) if axis == 0 else y  # (B, m, L)
        out = pease_stages(self.spec, rows.contiguous(), plan.stages[stage], 0, log_m, bitrev=True)
        return out.transpose(0, 1).contiguous() if axis == 0 else out

    def radix_fft(self, x_local: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """This rank's (n/d, L) slab of the natural-order Montgomery input ->
        its (n/d, L) slab of the transform (canonical), n = d * slab rows a
        power of two; every rank of the mesh calls it together."""
        d, L = self.mesh.size, self.spec.n_limbs
        n = x_local.shape[0] * d
        log_n = n.bit_length() - 1
        if 1 << log_n != n:
            raise ValueError(f"size must be a power of two, got {n} ({d} ranks x {x_local.shape[0]} rows)")
        plan = self.plan(log_n, inverse)
        n1, n2 = plan.n1, plan.n2
        x = x_local.to(self.mesh.device, self.f.dtype).reshape(n1 // d, n2, L)
        # exchange 1 gives (n1, n2/d, L), whole columns; the column DFTs
        # take it as their only reference, so it goes before their peak
        y = self._local(plan, 0, exchange(x, self.mesh, 1, 0), 0)
        y = self.f.mul(y, plan.tw)  # w^(k1 j2)
        y = exchange(y, self.mesh, 0, 1)  # (n1/d, n2, L): whole rows
        z = self._local(plan, 1, y, 1)  # row DFTs
        del y
        z = exchange(z, self.mesh, 1, 0)  # (n1, n2/d, L): Z[k1, k2], this rank's k2
        out = z.transpose(0, 1).reshape(n // d, L)  # X[k1 + n1 k2]
        del z
        if inverse and not plan.digit:
            out = self.f.mul(out, plan.n_inv)
        return out
