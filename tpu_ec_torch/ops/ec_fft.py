"""EC-group FFT: the radix-2 NTT over elliptic-curve points.

PyTorch counterpart of ``tpu_ec/ops/ec_fft.py``, the other half of the
reference fork's AMT stack beside the batch MSM (the generated kernel
``ag-build/cl/ec-fft.cl:4-76`` and the host programs
``ag-cuda-ec/src/ec_fft.rs:12-99``, ``ec-gpu-proxy/src/ec_fft.rs:164-280``).

The group FFT is linear over Fr: butterflies are point additions and
subtractions and the twiddles are scalar multiplications by w^e.  Same
constant-geometry (Pease) dataflow as ``ops/ntt.py``: stage s splits the
rows into halves a and b and writes u = a + b, v = [w^e](a - b) with
e = (i >> s) << s, interleaved; the output is bit-reversed back to natural
order (ark's Radix2EvaluationDomain convention) and the inverse transform
scales by n^-1.  On the card a stage is one launch of K3's EC-FFT stage
entry for every transform of a batch, the bit reversal one gather, and the
inverse's scaling one launch of K3's chain entry.  G2 runs the same
dataflow on K3's Fq2 instances (coordinates of ``PointOps.width`` = 2L).  The twiddle exponents
come as plain (non-Montgomery) scalar limbs from a host table built once a
domain.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch

from ..curves.params import CurveSpec
from ..curves.point import PointOps
from ..errors import Aborted
from ..fields.bigint import np_mont_mul
from ..fields.limbs import resolve_device
from ..fields.params import int_to_limbs
from ..kernels.point import ec_fft_stage
from ..utils.timer import phase
from .ntt import Domain, bit_reverse_permutation, get_domain, twiddle_table_np


class EcDomain:
    """Twiddle scalars (plain limbs) of one (curve, log_n, direction)."""

    def __init__(self, spec: CurveSpec, log_n: int, inverse: bool = False):
        self.spec = spec
        self.field_domain: Domain = get_domain(spec.scalar, log_n, inverse)
        self.log_n = log_n
        self.n = 1 << log_n
        self.inverse = inverse

    @functools.cached_property
    def twiddle_scalars(self) -> np.ndarray:
        """(n/2, Ls) uint32 plain w^j: the field domain's Montgomery table
        times one (a Montgomery product with 1 leaves the plain value)."""
        fr = self.spec.scalar
        table = twiddle_table_np(fr, self.field_domain.omega, self.log_n - 1)
        one = np.zeros((1, fr.n_limbs), np.uint32)
        one[0, 0] = 1
        return np_mont_mul(fr, table, one)

    @functools.cached_property
    def n_inv_scalar(self) -> np.ndarray:
        """(Ls,) plain limbs of n^-1 mod r, the inverse transform's scale."""
        fr = self.spec.scalar
        return int_to_limbs(pow(self.n, -1, fr.modulus), fr.n_limbs)

    @functools.cached_property
    def rev(self) -> np.ndarray:
        return bit_reverse_permutation(self.log_n)


@functools.lru_cache(maxsize=64)
def get_ec_domain(spec: CurveSpec, log_n: int, inverse: bool = False) -> EcDomain:
    with phase("build/ec_domain"):
        return EcDomain(spec, log_n, inverse)


class EcFftKernel:
    """The EC-FFT bound to one curve (G1 or G2) and device (EcFftKernel parity,
    ec-gpu-proxy/src/ec_fft.rs:164-280).  ``radix_ec_fft`` transforms one
    Jacobian batch, ``radix_ec_fft_many`` several; ``maybe_abort`` is polled
    before every transform (ec_fft.rs:100-104)."""

    def __init__(self, spec: CurveSpec, device="cuda", maybe_abort=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.ops = PointOps(spec, self.device)
        self.maybe_abort = maybe_abort
        self._tables: dict = {}

    def _check_abort(self):
        if self.maybe_abort is not None and self.maybe_abort():
            raise Aborted("EC-FFT aborted by hook")

    def _domain_tensors(self, log_n: int, inverse: bool):
        """(twiddle scalars (n/2, Ls), n^-1 (Ls,), bit reversal (n,)) on the
        device, built once."""
        key = (log_n, inverse)
        if key not in self._tables:
            with phase("build/ec_domain_tensors"):
                dom = get_ec_domain(self.spec, log_n, inverse)
                dtype = self.ops.fr.dtype
                self._tables[key] = (
                    torch.as_tensor(dom.twiddle_scalars.astype(np.int64)).to(self.device, dtype),
                    torch.as_tensor(dom.n_inv_scalar.astype(np.int64)).to(self.device, dtype),
                    torch.as_tensor(dom.rev.astype(np.int64)).to(self.device),
                )
        return self._tables[key]

    def _transform(self, P, inverse: bool):
        """The transforms along axis -2 of Jacobian coordinates (..., n, L)."""
        n = P[0].shape[-2]
        log_n = n.bit_length() - 1
        if n != 1 << log_n:
            raise ValueError(f"EC-FFT size must be a power of two, got {n}")
        if log_n == 0:
            return tuple(P)
        tw, n_inv, rev = self._domain_tensors(log_n, inverse)
        Y = tuple(P)
        for s in range(log_n):
            with phase("ec_fft/stage"):
                Y = ec_fft_stage(self.spec.base, Y, tw, s, ext=self.spec.ext)
        with phase("ec_fft/bit_reverse"):
            Y = tuple(c.index_select(-2, rev) for c in Y)
        if not inverse:
            return Y
        with phase("ec_fft/scale"):
            return self.ops.scalar_mul(Y, n_inv)

    def _span(self, P, inverse: bool, batch: int):
        """The entry span "ec_fft" of transforms of P's length."""
        return phase("ec_fft", curve=self.spec.name, n=P[0].shape[-2], batch=batch, inverse=inverse)

    def radix_ec_fft(self, P, inverse: bool = False):
        """The EC-FFT of one Jacobian batch P = (X, Y, Z), each (n, L) (L =
        ``PointOps.width``), n a power of two; natural order in and out."""
        self._check_abort()
        with self._span(P, inverse, math.prod(P[0].shape[:-2])):
            return self._transform(P, inverse)

    def radix_ec_fft_many(self, Ps, inverse: bool = False):
        """Several transforms.  A list of Jacobian batches of one length is
        stacked and run as one batch (one stage launch for all of them); a
        list of differing lengths runs one transform at a time, polling
        abort before each; a tuple (X, Y, Z) of (B, n, L) tensors is one
        stacked batch and comes back as one."""
        if isinstance(Ps, list) and len({P[0].shape[0] for P in Ps}) != 1:
            return [self.radix_ec_fft(P, inverse) for P in Ps]
        self._check_abort()
        if isinstance(Ps, list):
            with self._span(Ps[0], inverse, len(Ps)):
                res = self._transform(tuple(torch.stack(cs) for cs in zip(*Ps)), inverse)
            return [tuple(c[i] for c in res) for i in range(len(Ps))]
        with self._span(Ps, inverse, math.prod(Ps[0].shape[:-2])):
            return self._transform(Ps, inverse)


def radix_ec_fft(spec: CurveSpec, P, inverse: bool = False, device="cuda"):
    """Functional entry point (ag-cuda-ec/src/ec_fft.rs:12 parity)."""
    return EcFftKernel(spec, device).radix_ec_fft(P, inverse)
