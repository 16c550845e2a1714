"""Host-side worker pool (the reference's ``Worker`` / ``Waiter``).

PyTorch counterpart of ``tpu_ec/utils/threadpool.py``.  The reference wraps
a global pool sized by EC_GPU_NUM_THREADS (``ec-gpu-proxy/src/
threadpool.rs:13-30``) with ``Worker::compute`` returning a ``Waiter``
future (:36-113).  The card's work is queued on CUDA streams, so the pool
is for host work: input marshalling, referees, and host preparation that
overlaps the card.  Its size is config ``num_threads``
(``TPU_EC_TORCH_NUM_THREADS``), else the CPU count.
"""

from __future__ import annotations

import concurrent.futures as _fut
import math
import os

from ..config import get_config

_POOL: _fut.ThreadPoolExecutor | None = None


def pool_size() -> int:
    """Threads of the pool: config ``num_threads``, else the CPU count."""
    return max(1, get_config().num_threads or os.cpu_count() or 1)


def _pool() -> _fut.ThreadPoolExecutor:
    global _POOL
    if _POOL is None:
        _POOL = _fut.ThreadPoolExecutor(max_workers=pool_size())
    return _POOL


class Waiter:
    """A pending result (threadpool.rs:98-113)."""

    def __init__(self, future: _fut.Future):
        self._future = future

    def wait(self):
        """The result; re-raises the job's exception."""
        return self._future.result()

    def done(self) -> bool:
        return self._future.done()


class Worker:
    """``Worker::compute`` and ``scope`` on the process-wide pool
    (threadpool.rs:36-95)."""

    def __init__(self):
        self.pool = _pool()

    @staticmethod
    def log_num_threads() -> int:
        """log2 of the pool size, rounded down (threadpool.rs:91-95)."""
        return int(math.log2(pool_size()))

    def compute(self, fn, *args, **kwargs) -> Waiter:
        """Run ``fn(*args, **kwargs)`` on the pool."""
        return Waiter(self.pool.submit(fn, *args, **kwargs))

    def scope(self, elements: int, fn) -> list:
        """Split ``elements`` into one chunk a thread, run fn(start, length)
        on each and wait for all of them; the results in chunk order."""
        chunk = -(-elements // pool_size()) if elements else 0
        futs = [self.pool.submit(fn, start, min(chunk, elements - start)) for start in range(0, elements, chunk or 1)]
        return [f.result() for f in futs]
