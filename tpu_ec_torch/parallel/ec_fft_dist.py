"""The distributed batched EC-FFT: a batch of transforms dealt out by rank.

PyTorch counterpart of ``tpu_ec/parallel/ec_fft_dist.py``.  The reference
deals whole problems of a batch round-robin to its GPUs
(``ec-gpu-proxy/src/ec_fft.rs:241-279``); here each rank transforms its
contiguous slab of the batch with the single-card ``EcFftKernel`` (K3's
EC-FFT stage entry a stage, K3's chain entry for the inverse's scaling).
The transforms are independent, so there are no collectives.
"""

from __future__ import annotations

from ..curves.params import CurveSpec
from ..ops.ec_fft import EcFftKernel
from .mesh import Mesh


class DistEcFftKernel:
    """The sharded batched EC-FFT bound to one curve and mesh (the
    reference's multi-GPU ``EcFftKernel::radix_ec_fft_many``)."""

    def __init__(self, spec: CurveSpec, mesh: Mesh):
        self.spec = spec
        self.mesh = mesh
        self.kernel = EcFftKernel(spec, mesh.device)

    def radix_ec_fft_many(self, Ps_local, inverse: bool = False):
        """This rank's slab of a stacked Jacobian batch, (X, Y, Z) of
        (B/d, n, L) (``shard_leading`` of the (B, n, L) batch: B padded to a
        multiple of d with identity transforms) -> its transforms, the same
        shape."""
        dev = self.mesh.device
        return self.kernel.radix_ec_fft_many(tuple(c.to(dev) for c in Ps_local), inverse)
