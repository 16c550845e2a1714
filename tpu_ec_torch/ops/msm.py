"""Pippenger multi-scalar multiplication (MSM / "multiexp") entry point.

PyTorch counterpart of ``tpu_ec/ops/msm.py`` for signed digits: window
digits (``make_digits``), chunk sizing by device memory
(``calc_chunk_size``) and ``MultiexpKernel.multiexp`` on the pair-halving
engine (``ops/msm_pair.py``, the commit pipeline's) or the co-Z engine
(``ops/msm_coz.py``), with oversized inputs split into chunks whose partial
sums are added on the device.
"""

from __future__ import annotations

import torch

from ..config import get_config, get_logger
from ..curves.params import CurveSpec
from ..curves.point import PointOps
from ..errors import Aborted
from ..fields.limbs import resolve_device

SCALAR_BITS = 256  # Fr limb width for both supported curves (16 x 16-bit)


def _window_raws(scalars: torch.Tensor, w: int, num_windows: int) -> list[torch.Tensor]:
    """Unsigned base-2^w digits of (n, Ls+1) zero-padded scalar limbs; window
    j covers bits [j*w, (j+1)*w).  Computed in int64 (a 32-bit merge of two
    half-limbs does not fit int32)."""
    s = scalars.to(torch.int64)
    mask = (1 << w) - 1
    out = []
    for j in range(num_windows):
        li, ofs = divmod(j * w, 16)
        merged = s[:, li] | (s[:, li + 1] << 16)
        out.append((merged >> ofs) & mask)
    return out


def _recode_signed(raws: list[torch.Tensor], w: int) -> torch.Tensor:
    """Carry-chain signed recode: digits in [-2^(w-1), 2^(w-1)]."""
    half = 1 << (w - 1)
    digits = []
    c = torch.zeros_like(raws[0])
    for r in raws:
        t = r + c
        c = (t > half).to(t.dtype)
        digits.append(t - (c << w))
    return torch.stack(digits, dim=-1)


def make_digits(scalars: torch.Tensor, w: int, num_windows: int, signed: bool) -> torch.Tensor:
    """(n, Ls+1) zero-padded plain scalar limbs -> (n, W) int32 digits."""
    raws = _window_raws(scalars, w, num_windows)
    d = _recode_signed(raws, w) if signed else torch.stack(raws, dim=-1)
    return d.to(torch.int32)


# int32 coordinate-sized arrays live per point and window at the peak of the
# window-batched pair engine (gathered rows, round-0 output, temporaries):
# 10 x 20 x 24 x 4 B = 19.2 KB per BLS12-381 point, against a measured peak
# of 17.56 GiB for one 2^20 commit (18 KB per point) on an H100
_WORKSET_ARRAYS = 10
_WORKSET_WINDOWS = 20  # windows at the default window size for 2^18 - 2^24


def calc_chunk_size(spec: CurveSpec, device, hbm_budget_bytes: int | None = None) -> int:
    """Most points per MSM launch that fit the device-memory budget: the
    budget is ``msm_hbm_budget_bytes`` or, when unset, the free memory the
    card reports (4 GiB on the CPU); half of it goes to the engine's
    working set of ~_WORKSET_ARRAYS * W coordinate arrays per point."""
    if hbm_budget_bytes is None:
        hbm_budget_bytes = get_config().msm_hbm_budget_bytes
    if hbm_budget_bytes is None:
        dev = torch.device(device)
        hbm_budget_bytes = torch.cuda.mem_get_info(dev)[0] if dev.type == "cuda" else 4 << 30
    L = spec.base.n_limbs * spec.ext
    per_point = _WORKSET_ARRAYS * _WORKSET_WINDOWS * L * 4
    n = (hbm_budget_bytes // 2) // per_point
    return max(1 << 12, 1 << (n.bit_length() - 1))  # round down to pow2


# engines of tpu_ec's multiexp that the port has not ported yet, and where
# ROADMAP.md queues them
_NOT_PORTED = {"sorted": "item 15", "scan": "item 8", "lattice": "item 11"}


class MultiexpKernel:
    """MSM entry point bound to one G1 curve and device."""

    def __init__(self, spec: CurveSpec, device="cuda", maybe_abort=None,
                 chunk_size: int | None = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.ops = PointOps(spec, self.device)
        self.maybe_abort = maybe_abort
        self.chunk_size = chunk_size or calc_chunk_size(spec, self.device)

    def _check_abort(self):
        if self.maybe_abort is not None and self.maybe_abort():
            raise Aborted("MSM aborted by hook")

    def multiexp(self, bases, scalars: torch.Tensor, *, window_size: int | None = None,
                 method: str = "auto"):
        """sum_i scalars[i] * bases[i] -> one Jacobian point (batch (1,)).

        ``bases`` are affine (x, y) of (n, L) ((0, 0) = identity);
        ``scalars`` are (n, Ls) plain-integer limbs (not Montgomery; see
        ``PointOps.scalars_to_limbs``).  ``method``: "pair" (the
        pair-halving engine, which "auto" picks) or "coz" (the co-Z
        scaled-affine engine)."""
        from .msm_coz import default_window_size_coz, msm_coz
        from .msm_pair import default_window_size_pair, msm_pair

        self._check_abort()
        if method == "auto":
            method = "pair"
        if method in _NOT_PORTED:
            raise NotImplementedError(
                f"MSM engine {method!r} is not ported yet (ROADMAP.md queue 1, {_NOT_PORTED[method]})"
            )
        engines = {"pair": (msm_pair, default_window_size_pair),
                   "coz": (msm_coz, default_window_size_coz)}
        if method not in engines:
            raise ValueError(f"unknown MSM method {method!r}")
        n = bases[0].shape[0]
        if n > self.chunk_size:
            return self._multiexp_chunked(bases, scalars, window_size, method)
        engine, default_w = engines[method]
        w = window_size or get_config().msm_window or default_w(n)
        get_logger("tpu_ec_torch.msm").info(
            "MSM n=%d curve=%s engine=%s window=%d", n, self.spec.name, method, w
        )
        s = torch.cat([scalars, scalars.new_zeros((n, 1))], dim=1)
        return engine(self.ops, bases, s, window_size=w)

    def _multiexp_chunked(self, bases, scalars, window_size, method):
        """Split an oversized MSM into chunk_size pieces and add the partial
        Jacobian results on the device."""
        n = bases[0].shape[0]
        c = self.chunk_size
        get_logger("tpu_ec_torch.msm").info(
            "MSM n=%d exceeds chunk_size=%d: %d chunks", n, c, -(-n // c)
        )
        acc = None
        for lo in range(0, n, c):
            self._check_abort()
            b = tuple(t[lo : lo + c] for t in bases)
            part = self.multiexp(b, scalars[lo : lo + c], window_size=window_size, method=method)
            acc = part if acc is None else self.ops.add(acc, part)
        return acc

    def upload_bases(self, bases):
        """Pin an affine base table on the device, in the storage dtype, for
        reuse across calls (the SRS is uploaded once)."""
        return tuple(
            torch.as_tensor(t).to(device=self.device, dtype=self.ops.fq.dtype).contiguous()
            for t in bases
        )
