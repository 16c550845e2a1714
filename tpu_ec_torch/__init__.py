"""tpu_ec_torch: the PyTorch + CUDA port of tpu_ec for NVIDIA Hopper.

The same library surface as the JAX package ``tpu_ec`` (which stays the
reference), rebuilt on PyTorch: Montgomery field arithmetic on 16-bit
half-limbs, the digit-matmul NTT, G1 point arithmetic, the pair-halving
Pippenger MSM and the commit pipeline.  Every TPU (Pallas) kernel on the
ported path is a hand-written CUDA C++ kernel for sm_90a (``csrc/``), built
at first use; on CPU tensors each kernel wrapper runs its plain PyTorch
version.  This package never imports jax or tpu_ec.
"""

__version__ = "0.1.0"
