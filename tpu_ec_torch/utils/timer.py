"""Per-phase wall-clock timing (the reference's ``timer`` cargo feature).

PyTorch counterpart of ``tpu_ec/utils/timer.py``.  The reference prints
per-phase microseconds when built with the feature
(``ag-cuda-proxy/src/kernel.rs:17-18, 57-93, 214-220``).  Here phases are
nestable context managers that record host wall time into ``STATS`` when
enabled (config ``timer``, ``TPU_EC_TORCH_TIMER=1``, or :func:`enable`),
and cost one flag test when not.  A phase around work queued on the card
times the queueing unless the work inside synchronises; device times come
from CUDA events or torch.profiler.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

from ..config import get_config

_ENABLED: bool | None = None  # None: config ``timer`` decides, read at the first phase
_LOCAL = threading.local()


class PhaseStats:
    """Seconds recorded per phase label."""

    def __init__(self):
        self.records: dict[str, list[float]] = collections.defaultdict(list)

    def add(self, label: str, seconds: float) -> None:
        self.records[label].append(seconds)

    def summary(self) -> dict[str, dict[str, float]]:
        """{label: {count, total_s, mean_us}}."""
        return {label: {"count": len(xs), "total_s": sum(xs), "mean_us": 1e6 * sum(xs) / len(xs)}
                for label, xs in self.records.items()}

    def reset(self) -> None:
        self.records.clear()


STATS = PhaseStats()


def enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = get_config().timer
    return _ENABLED


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


@contextlib.contextmanager
def phase(label: str):
    """``with timer.phase("msm/prepare"):`` records the block's wall time
    when enabled; a phase inside another records under "outer/inner"."""
    if not enabled():
        yield
        return
    stack = getattr(_LOCAL, "stack", None)
    if stack is None:
        stack = _LOCAL.stack = []
    stack.append(label)
    full = "/".join(stack)
    t0 = time.perf_counter()
    try:
        yield
    finally:
        STATS.add(full, time.perf_counter() - t0)
        stack.pop()


def report() -> str:
    """One line a phase: count, total ms, mean us."""
    return "\n".join(f"{label}: n={s['count']} total={s['total_s'] * 1e3:.2f}ms mean={s['mean_us']:.0f}us"
                     for label, s in sorted(STATS.summary().items()))
