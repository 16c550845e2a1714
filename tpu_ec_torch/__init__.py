"""tpu_ec_torch: the PyTorch + CUDA port of tpu_ec for NVIDIA Hopper.

The same library surface as the JAX package ``tpu_ec`` (which stays the
reference), rebuilt on PyTorch: Montgomery field arithmetic on 16-bit
half-limbs and Fq2, the Pease, digit-matmul and fused NTTs, G1 and G2 point
arithmetic, batch-affine and co-Z point addition, the pair-halving, co-Z,
scan and sorted Pippenger MSM engines and the bucket lattice (G2 on the scan
engine), the EC-group FFT, the commit pipeline, and the multi-device layer
(``parallel``: the four-step NTT, the bucket-space MSM and the batched
EC-FFT over torch.distributed, one rank a card).  Every TPU (Pallas) kernel on the
ported path is a hand-written CUDA C++ kernel for sm_90a (``csrc/``), built
at first use; on CPU tensors each kernel wrapper runs its plain PyTorch
version.  The entry points run on the card (``device="cuda"``) unless the
caller passes ``device="cpu"``.  This package never imports jax or tpu_ec.
"""

__version__ = "0.1.0"
