"""KZG/AMT-style commit pipeline: NTT -> from_mont -> MSM, on one device.

PyTorch counterpart of ``tpu_ec/ops/pipeline.py::CommitPipeline``:

    evals  = NTT(coeffs)               (digit-matmul NTT: int8 GEMM + K2)
    commit = MSM(basis_points, evals)  (pair engine: K3, K1 in to_affine)

``coeffs`` are Fr elements in Montgomery form; the MSM's digit extraction
needs plain integers, so one ``from_mont`` pass (K1) sits between the two
stages, on the device.  ``commit_coefficient_basis`` skips the NTT (plain
KZG against an SRS); ``commit_sparse`` drops the terms a density query
leaves untouched before the MSM (``ops/density.py``).
"""

from __future__ import annotations

import torch

from ..curves.params import CurveSpec
from ..fields.fp import FieldOps
from ..fields.limbs import resolve_device
from ..utils.timer import phase
from .density import compact_by_density
from .msm import MultiexpKernel
from .ntt import FftKernel


class CommitPipeline:
    """NTT -> from_mont -> MSM against a fixed G1 or G2 point table (SRS
    analog); the MSM's "auto" engine is the pair engine, on G1 and G2."""

    def __init__(self, spec: CurveSpec, device="cuda", maybe_abort=None):
        self.spec = spec
        self.device = resolve_device(device)
        self.fr = FieldOps(spec.scalar, self.device)
        self.fft = FftKernel(spec.scalar, self.device, maybe_abort=maybe_abort)
        self.msm = MultiexpKernel(spec, self.device, maybe_abort=maybe_abort)
        self.ops = self.msm.ops

    def commit(self, coeffs: torch.Tensor, basis):
        """coeffs: (n, Ls) Fr Montgomery limbs; basis: affine (x, y) of n G1
        or G2 points.  Returns (evals (n, Ls) Montgomery, commitment: a Jacobian
        point with batch shape (1,))."""
        with phase("commit", curve=self.spec.name, n=coeffs.shape[0]):
            evals = self.fft.radix_fft(coeffs)
            with phase("from_mont"):
                scalars = self.fr.from_mont(evals)  # plain ints for digit extraction
            return evals, self.msm.multiexp(basis, scalars)

    def commit_coefficient_basis(self, coeffs: torch.Tensor, srs):
        """Commit in the coefficient basis (plain KZG, C = sum c_i [tau^i]G):
        no NTT, one from_mont (K1) and the MSM.  Returns the commitment, a
        Jacobian point with batch shape (1,)."""
        with phase("commit", curve=self.spec.name, n=coeffs.shape[0], basis="coefficient"):
            with phase("from_mont"):
                scalars = self.fr.from_mont(coeffs)
            return self.msm.multiexp(srs, scalars)

    def commit_sparse(self, coeffs: torch.Tensor, basis, density, skip: int = 0):
        """R1CS-style sparse commit (the reference prover's DensityTracker
        path, multiexp_cpu.rs:85-207): from_mont, then only the terms that
        ``density`` (a DensityTracker or FullDensity over the coefficient
        slots) touches, with bases read from offset ``skip``, go to the
        MSM.  Returns the commitment, a Jacobian point with batch shape (1,)."""
        with phase("commit", curve=self.spec.name, n=coeffs.shape[0], basis="sparse"):
            with phase("from_mont"):
                scalars = self.fr.from_mont(coeffs)
            return self.msm.multiexp(*compact_by_density(density, basis, scalars, skip=skip))
