"""The hand-written CUDA kernels (csrc/), their wrappers and plain versions.

K1 ``mont.mont_mul``, K2 ``inter.inter_twiddle``, K3 ``point.point_op``.
Each wrapper runs its plain PyTorch version on CPU tensors and launches its
kernel on CUDA tensors (or raises), and counts its launches.
"""

from . import inter, mont, point


def launch_counters() -> dict:
    """{kernel name: launches so far} for K1, K2 and K3."""
    return {m.LAUNCHES.name: m.LAUNCHES.count for m in (mont, inter, point)}


def reset_launch_counters() -> None:
    for m in (mont, inter, point):
        m.LAUNCHES.count = 0
