"""Shared parts of the sorted-bucket MSM engines: the static round sizes.

PyTorch counterpart of ``tpu_ec/ops/msm_sorted.py::_plan_sizes`` (the
sorted engine itself is not ported).  Its ``_triangular_sum`` is
``ops/msm_scan.py::bucket_tail``: the same masked prefix scan and tree sum.
"""

from __future__ import annotations


def _plan_sizes(n: int, half: int) -> list[int]:
    """Static compaction sizes for the shrinking halving rounds: shrink while
    the geometric term dominates the ~(half + 6) fixed point, then hand off
    to the constant-size rounds."""
    sizes = []
    s = n
    floor = int(1.25 * (half + 6)) + 8
    while s > floor:
        nxt = min(s, s // 2 + half // 2 + 3)
        if nxt >= s:
            break
        s = nxt
        sizes.append(s)
    return sizes
