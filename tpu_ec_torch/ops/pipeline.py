"""KZG/AMT-style commit pipeline: NTT -> from_mont -> MSM, on one device.

PyTorch counterpart of ``tpu_ec/ops/pipeline.py::CommitPipeline.commit``:

    evals  = NTT(coeffs)               (digit-matmul NTT: int8 GEMM + K2)
    commit = MSM(basis_points, evals)  (pair engine: K3, K1 in to_affine)

``coeffs`` are Fr elements in Montgomery form; the MSM's digit extraction
needs plain integers, so one ``from_mont`` pass (K1) sits between the two
stages, on the device.
"""

from __future__ import annotations

import torch

from ..curves.params import CurveSpec
from ..fields.fp import FieldOps
from ..fields.limbs import resolve_device
from .msm import MultiexpKernel
from .ntt import FftKernel


class CommitPipeline:
    """NTT -> from_mont -> MSM against a fixed G1 point table (SRS analog)."""

    def __init__(self, spec: CurveSpec, device="cuda", maybe_abort=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.fr = FieldOps(spec.scalar, self.device)
        self.fft = FftKernel(spec.scalar, self.device, maybe_abort=maybe_abort)
        self.msm = MultiexpKernel(spec, self.device, maybe_abort=maybe_abort)
        self.ops = self.msm.ops

    def commit(self, coeffs: torch.Tensor, basis):
        """coeffs: (n, Ls) Fr Montgomery limbs; basis: affine (x, y) of n G1
        points.  Returns (evals (n, Ls) Montgomery, commitment: a Jacobian
        point with batch shape (1,))."""
        evals = self.fft.radix_fft(coeffs)
        scalars = self.fr.from_mont(evals)  # plain ints for digit extraction
        return evals, self.msm.multiexp(basis, scalars)
