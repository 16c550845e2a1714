"""Number-theoretic transform (finite-field FFT) over two-adic fields.

PyTorch counterpart of ``tpu_ec/ops/ntt.py``.  Conventions match
``ark_poly::Radix2EvaluationDomain``: natural order in and out,
X_k = sum_j x_j w^(jk), w = root_of_unity^(2^(s - log_n)); the inverse
transform scales by n^-1.

Routing is by size and config alone, on every device: log_n >= 10 runs the
route that config ``ntt_impl`` names, "digit" (``ops/ntt_digit.py``: int8
leaf GEMMs and kernel K2, the default) or "fused" (``ops/ntt_fused.py``:
block-resident leaves, kernel K4); smaller transforms run the
constant-geometry Pease NTT below, one kernel-K5 launch for every stage.
``tpu_ec`` routes on the backend too; all routes are bit-exact equal, so
the CPU tests walk the path the card walks.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import get_config
from ..errors import Aborted
from ..fields.fp import FieldOps
from ..fields.limbs import resolve_device, storage_dtype
from ..fields.params import FieldSpec, int_to_limbs
from ..kernels.butterfly import pease_stages
from ..utils.timer import phase

MAX_LOG2_FFT = 32
DIGIT_MIN_LOG = 10  # log_n at and above which the ntt_impl route (digit or fused) runs


def twiddle_table_np(spec: FieldSpec, omega: int, log_len: int) -> np.ndarray:
    """(2^log_len, L) numpy table of omega^j in Montgomery form."""
    from ..fields.bigint import np_mont_mul

    table = int_to_limbs(spec.one, spec.n_limbs)[None, :].astype(np.uint32)
    w_pow = omega
    for _ in range(log_len):
        scale = int_to_limbs(spec.to_mont(w_pow), spec.n_limbs)
        table = np.concatenate([table, np_mont_mul(spec, table, scale[None, :])], axis=0)
        w_pow = (w_pow * w_pow) % spec.modulus
    return table


def bit_reverse_permutation(log_n: int) -> np.ndarray:
    """Index permutation reversing log_n-bit indices."""
    n = 1 << log_n
    idx = np.arange(n, dtype=np.uint32)
    rev = np.zeros_like(idx)
    for b in range(log_n):
        rev |= ((idx >> b) & 1) << (log_n - 1 - b)
    return rev


class Domain:
    """Radix-2 evaluation domain of a fixed (field, log_n, direction)."""

    def __init__(self, spec: FieldSpec, log_n: int, inverse: bool = False):
        if log_n > min(spec.two_adicity, MAX_LOG2_FFT):
            raise ValueError(
                f"domain 2^{log_n} exceeds two-adicity {spec.two_adicity} of {spec.name}"
            )
        self.spec = spec
        self.log_n = log_n
        self.n = 1 << log_n
        p = spec.modulus
        omega = pow(spec.root_of_unity, 1 << (spec.two_adicity - log_n), p)
        if inverse:
            omega = pow(omega, p - 2, p)
        self.omega = omega
        self.inverse = inverse

    @functools.cached_property
    def twiddles(self) -> np.ndarray:
        """(n/2, L) numpy table of w^j in Montgomery form."""
        return twiddle_table_np(self.spec, self.omega, self.log_n - 1)

    @functools.cached_property
    def n_inv(self) -> int:
        return pow(self.n, -1, self.spec.modulus)


@functools.lru_cache(maxsize=64)
def get_domain(spec: FieldSpec, log_n: int, inverse: bool = False) -> Domain:
    with phase("build/ntt_domain"):
        return Domain(spec, log_n, inverse)


def _ntt_impl(f: FieldOps, dom: Domain, x: torch.Tensor, tw: torch.Tensor) -> torch.Tensor:
    """Constant-geometry (Pease) decimation-in-frequency radix-2 NTT along
    axis -2 of x (..., n, L): every stage butterflies the halves into
    u = a + b, v = (a - b) * w^e with e = (i >> s) << s, interleaved, and
    the output is bit-reversed back to natural order (``tpu_ec/ops/ntt.py::
    _ntt_impl``, the staged run of ``tpu_ec/ops/pallas/ntt.py::
    PallasFftKernel``): one kernel-K5 launch over every stage and row.
    ``tw`` is the domain's (n/2, L) master table on x's device."""
    if dom.log_n == 0:
        return x
    return pease_stages(f.spec, x.contiguous(), tw, 0, dom.log_n, bitrev=True)


class FftKernel:
    """Field FFT bound to one field and device: ``radix_fft``,
    ``radix_fft_many`` and ``mul_by_field``."""

    def __init__(self, spec: FieldSpec, device="cuda", maybe_abort=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.f = FieldOps(spec, self.device)
        self.maybe_abort = maybe_abort
        self._consts = {}

    def _check_abort(self):
        if self.maybe_abort is not None and self.maybe_abort():
            raise Aborted("FFT aborted by hook")

    def _large(self, x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
        """log_n >= DIGIT_MIN_LOG: the route config ``ntt_impl`` names.

        The digit route's tables stay cached per domain, that is per
        (log_n, inverse) under the module's thresholds: from 2^22 to below
        ``ntt_digit._CHUNK_MIN`` the level-0 Bailey table is materialised
        on the card, 64 bytes an element (1 GiB a direction at 2^24, and
        4 GiB at 2^26 where the thresholds leave 2^26 unchunked); chunked
        sizes keep only the level's factored seeds.  The transform reads
        and writes x's (n, L) rows, with no transposed copy of either."""
        cfg = get_config()
        key = (cfg.ntt_impl, log_n, inverse)
        if cfg.ntt_impl == "digit":
            from .ntt_digit import digit_consts, digit_ntt_rows, get_digit_domain, leaf_log

            dom = get_digit_domain(self.spec, log_n, inverse, leaf_log(log_n))
            key = ("digit", dom)
            if key not in self._consts:
                self._consts[key] = digit_consts(dom, self.device)
            return digit_ntt_rows(self.spec, x.contiguous(), inverse, consts=self._consts[key])
        if cfg.ntt_impl == "fused":
            from .ntt_fused import fused_consts, fused_ntt, get_fused_domain

            dom = get_fused_domain(self.spec, log_n, inverse)
            key += (dom.leaf,)
            if key not in self._consts:
                with phase("build/fused_consts"):
                    self._consts[key] = fused_consts(dom, self.device)
            return fused_ntt(self.f, dom, x, self._consts[key])
        raise ValueError(f"unknown ntt_impl {cfg.ntt_impl!r} (digit or fused)")

    def _small(self, x: torch.Tensor, log_n: int, inverse: bool) -> torch.Tensor:
        """log_n < DIGIT_MIN_LOG, any batch (..., n, L): the Pease loop."""
        dom = get_domain(self.spec, log_n, inverse)
        key = ("pease", log_n, inverse, x.device)
        if key not in self._consts:
            with phase("build/ntt_twiddles"):
                self._consts[key] = torch.as_tensor(dom.twiddles.astype(np.int64), device=x.device).to(
                    storage_dtype(x.device))
        y = _ntt_impl(self.f, dom, x, self._consts[key])
        return self.mul_by_field(y, dom.n_inv) if inverse else y

    def radix_fft(self, x: torch.Tensor, inverse: bool = False) -> torch.Tensor:
        """NTT of an (n, L) Montgomery batch; returns (n, L) canonical values."""
        log_n = _log2_size(x.shape[0])
        self._check_abort()
        with phase("ntt", field=self.spec.name, n=x.shape[0], inverse=inverse):
            if log_n >= DIGIT_MIN_LOG:
                return self._large(x, log_n, inverse)
            return self._small(x, log_n, inverse)

    def radix_fft_many(self, xs, inverse: bool = False):
        """Batched transform: ``xs`` is (B, n, L) or a list of (n, L).  Below
        2^DIGIT_MIN_LOG the Pease NTT runs over the whole batch in one
        launch; larger transforms run one at a time, as tpu_ec does."""
        if isinstance(xs, (list, tuple)):
            out = []
            for x in xs:
                self._check_abort()
                out.append(self.radix_fft(x, inverse))
            return out
        self._check_abort()
        log_n = _log2_size(xs.shape[1])
        with phase("ntt", field=self.spec.name, n=xs.shape[1], batch=xs.shape[0], inverse=inverse):
            if log_n >= DIGIT_MIN_LOG:
                return torch.stack([self.radix_fft(x, inverse) for x in xs])
            return self._small(xs, log_n, inverse)

    def mul_by_field(self, x: torch.Tensor, scalar) -> torch.Tensor:
        """Elementwise scale by one field element (kernel K1): ``scalar`` is
        a Python int or an (L,) Montgomery limb tensor."""
        if isinstance(scalar, int):
            scalar = self.f.constant(scalar)
        return self.f.mul(x, scalar.to(device=x.device, dtype=x.dtype))


def _log2_size(n: int) -> int:
    log_n = int(n).bit_length() - 1
    if n < 1 or 1 << log_n != n:
        raise ValueError("FFT size must be a power of two")
    return log_n


def ntt(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Forward NTT of an (n, L) Montgomery batch on ``x``'s device."""
    return FftKernel(spec, x.device).radix_fft(x)


def intt(spec: FieldSpec, x: torch.Tensor) -> torch.Tensor:
    """Inverse NTT of an (n, L) Montgomery batch on ``x``'s device."""
    return FftKernel(spec, x.device).radix_fft(x, inverse=True)


def ntt_ref(spec: FieldSpec, values: list[int], inverse: bool = False) -> list[int]:
    """Python bigint radix-2 NTT oracle (plain integers, natural order)."""
    n = len(values)
    log_n = n.bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("NTT size must be a power of two")
    p = spec.modulus
    omega = pow(spec.root_of_unity, 1 << (spec.two_adicity - log_n), p)
    if inverse:
        omega = pow(omega, p - 2, p)
    a = [values[int(i)] for i in bit_reverse_permutation(log_n)]
    m = 1
    while m < n:
        w_m = pow(omega, n // (2 * m), p)
        for k in range(0, n, 2 * m):
            w = 1
            for j in range(m):
                t = (a[k + j + m] * w) % p
                a[k + j + m] = (a[k + j] - t) % p
                a[k + j] = (a[k + j] + t) % p
                w = (w * w_m) % p
        m *= 2
    if inverse:
        ninv = pow(n, -1, p)
        a = [(v * ninv) % p for v in a]
    return a
