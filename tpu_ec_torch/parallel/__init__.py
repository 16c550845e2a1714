"""The multi-device layer: the mesh, the four-step NTT, the bucket-space MSM
and the batched EC-FFT over torch.distributed (one rank a card)."""

from .ec_fft_dist import DistEcFftKernel
from .mesh import Mesh, gather_leading, init_rank, make_mesh, run_spmd, shard_leading
from .msm_dist import DistMultiexpKernel
from .ntt_dist import DistFftKernel

__all__ = [
    "Mesh",
    "make_mesh",
    "shard_leading",
    "gather_leading",
    "init_rank",
    "run_spmd",
    "DistFftKernel",
    "DistMultiexpKernel",
    "DistEcFftKernel",
]
