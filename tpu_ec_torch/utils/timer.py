"""Spans of the port's work, and the per-phase timer (the reference's
``timer`` cargo feature).

PyTorch counterpart of ``tpu_ec/utils/timer.py``; the reference prints
per-phase microseconds when built with the feature
(``ag-cuda-proxy/src/kernel.rs:17-18, 57-93, 214-220``).  A span,
``with timer.phase("msm/pair/round"):``, marks one stage of the work, and
costs what its listeners ask for:

- no torch profiler recording and config ``timer`` off (the default): one
  flag test, torch's own ``torch.autograd.profiler._is_profiler_enabled``
  (kept by torch for fast Python checks), and nothing else;
- while a torch profiler records: a ``torch.profiler.record_function``
  range named ``"tpu_ec_torch/" + label``, on the timeline the profiler's
  device operations share.  The label is the one written at the call site;
  a span opened inside another is its child in the profiler's nesting.
  Keyword ``args`` (curve, n, engine, window, ...) become the range's
  argument string, formatted only while the profiler records;
- with config ``timer`` on (``TPU_EC_TORCH_TIMER=1``, or :func:`enable`):
  the block's host wall time under its nested label ("outer/inner"), and,
  where CUDA is in use, a CUDA event pair recorded on the current stream
  at enter and exit.  :func:`summary` and :func:`report` resolve the
  events with one synchronise, never inside a span.  Device ms is the
  stream's time from entering the span to leaving it, idle included; host
  ms is the enqueue's wall time unless the block waits for the card.

Two kinds of span by label prefix: ``wait/<site>`` around a call that
blocks the host on the card, and ``build/<what>`` on the miss path of a
cache that builds something (the kernel library, a table, a domain).
"""

from __future__ import annotations

import collections
import threading
import time

import torch
from torch.autograd import profiler as _profiler

from ..config import get_config

PREFIX = "tpu_ec_torch/"  #: the profiler range of span "x" is PREFIX + "x"

_ENABLED: bool | None = None  # None: config ``timer`` decides, read at the first span
_LOCAL = threading.local()


class PhaseStats:
    """Host seconds, and CUDA event pairs until resolved, per nested label."""

    def __init__(self):
        self.records: dict[str, list[float]] = collections.defaultdict(list)
        self._events: dict[str, list] = collections.defaultdict(list)
        self._device_ms: dict[str, list[float]] = collections.defaultdict(list)

    def add(self, label: str, seconds: float, events=None) -> None:
        self.records[label].append(seconds)
        if events is not None:
            self._events[label].append(events)

    def summary(self) -> dict[str, dict]:
        """{label: {count, total_s, mean_us, device_ms}}: host seconds in
        all and mean microseconds, and the stream's milliseconds in all,
        None for a label with no CUDA events (the CPU)."""
        if self._events:
            torch.cuda.synchronize()
            for label, pairs in self._events.items():
                self._device_ms[label].extend(a.elapsed_time(b) for a, b in pairs)
            self._events.clear()
        out = {}
        for label, xs in self.records.items():
            dev = self._device_ms.get(label)
            out[label] = {"count": len(xs), "total_s": sum(xs), "mean_us": 1e6 * sum(xs) / len(xs),
                          "device_ms": sum(dev) if dev else None}
        return out

    def reset(self) -> None:
        self.records.clear()
        self._events.clear()
        self._device_ms.clear()


STATS = PhaseStats()


def enabled() -> bool:
    global _ENABLED
    if _ENABLED is None:
        _ENABLED = get_config().timer
    return _ENABLED


def enable(on: bool = True) -> None:
    global _ENABLED
    _ENABLED = on


def _cuda_event():
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


class phase:
    """``with phase(label, **args):`` one span (see the module docstring)."""

    __slots__ = ("label", "args", "_range", "_t0", "_start")

    def __init__(self, label: str, **args):
        self.label = label
        self.args = args
        self._range = self._t0 = None

    def __enter__(self):
        on = _ENABLED
        if on is None:
            on = enabled()
        if not (on or _profiler._is_profiler_enabled):
            return self
        if _profiler._is_profiler_enabled:
            text = " ".join(f"{k}={v}" for k, v in self.args.items()) if self.args else None
            self._range = torch.profiler.record_function(PREFIX + self.label, text)
            self._range.__enter__()
        if on:
            stack = getattr(_LOCAL, "stack", None)
            if stack is None:
                stack = _LOCAL.stack = []
            stack.append(self.label)
            self._start = _cuda_event() if torch.cuda.is_initialized() else None
            self._t0 = time.perf_counter()
        return self

    def __exit__(self, *exc):
        if self._t0 is not None:
            seconds = time.perf_counter() - self._t0
            stack = _LOCAL.stack
            events = None if self._start is None else (self._start, _cuda_event())
            STATS.add("/".join(stack), seconds, events)
            stack.pop()
        if self._range is not None:
            self._range.__exit__(*exc)
        return False


def summary() -> dict[str, dict]:
    return STATS.summary()


def report() -> str:
    """One line a label: count, host ms (total and mean), device ms (null
    without CUDA events)."""
    lines = []
    for label, s in sorted(summary().items()):
        dev = "null" if s["device_ms"] is None else f"{s['device_ms']:.3f}ms"
        lines.append(f"{label}: n={s['count']} total={s['total_s'] * 1e3:.2f}ms mean={s['mean_us']:.0f}us "
                     f"device={dev}")
    return "\n".join(lines)
