"""Honest device timing: forced-execution sync and throughput helpers.

CUDA launches return before the device finishes, so a host clock read
without a synchronise measures the enqueue.  ``hard_sync`` synchronises the
device and reads one element of every result back to the host; ``timeit``
times calls that end in it.
"""

from __future__ import annotations

import time

import torch

H100_HBM_BYTES_PER_S = 3.35e12  # NVIDIA H100 SXM data sheet


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (tuple, list)):
        return [leaf for item in x for leaf in _leaves(item)]
    return []


def hard_sync(x) -> None:
    """Block until ``x`` (a tensor or nested tuple of tensors) is computed."""
    leaves = _leaves(x)
    if any(t.device.type == "cuda" for t in leaves):
        torch.cuda.synchronize()
    for t in leaves:
        if t.numel():
            t.reshape(-1)[:1].cpu()


def timeit(fn, *args, iters: int = 5, warmup: int = 1) -> float:
    """Seconds per call of ``fn(*args)``: ``iters`` calls after ``warmup``,
    one hard sync at the end."""
    out = None
    for _ in range(warmup):
        out = fn(*args)
    hard_sync(out)
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    hard_sync(out)
    return (time.perf_counter() - t0) / iters


def physically_possible(bytes_per_call: int, seconds: float,
                        hbm_bw: float = H100_HBM_BYTES_PER_S) -> bool:
    """False for a measurement implying more memory bandwidth than the card
    has: the harness failed to synchronise."""
    return bytes_per_call / max(seconds, 1e-12) < hbm_bw
