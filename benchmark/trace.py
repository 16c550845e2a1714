"""torch.profiler over a few ops, reduced to a device timeline.

``trace_ops`` runs ``count`` ops, each inside the harness's own ranges
(``bench/op`` around the call, ``bench/read_back`` around the synchronised
read-back, ``bench/window`` around them all), under torch.profiler with CPU
and CUDA activities.  A trace that holds no device time, which torch.profiler
gives at times, is taken again, up to three times; on a multi-rank cell the
ranks take it again together.  ``Trace`` keeps the device operations' intervals and
names, the window's bounds and the host's events, from which the readers in
``benchmark/metrics`` take busy time, idle share and device time by kernel.
"""

from __future__ import annotations

import re

WINDOW, OP, READ_BACK = "bench/window", "bench/op", "bench/read_back"


def kernel_ident(name: str) -> str:
    """The bare function name of a demangled kernel name
    ("void (anonymous namespace)::f<3>(A)" -> "f")."""
    name = name.replace("(anonymous namespace)::", "")
    m = re.match(r"\s*(?:void\s+)?([\w:]+)", name)
    return m.group(1).rsplit("::", 1)[-1] if m else name


def mangled_ident(symbol: str) -> str | None:
    """The function name of an Itanium-mangled symbol: the last source name
    of "_Z<len><name>..." or of the nested "_ZN<len><name><len><name>...",
    as in "_ZN38_GLOBAL__N__68979d72_6_ntt_cu_5814667f15ntt_leaf_kernelI..."."""
    if not symbol.startswith("_Z"):
        return None
    s, last = symbol[2:], None
    if s.startswith("N"):
        s = s[1:]
    while s and s[0].isdigit():
        digits = re.match(r"\d+", s).group(0)
        n = int(digits)
        last, s = s[len(digits) : len(digits) + n], s[len(digits) + n :]
    return last


def mangled_idents(ptxas_report: str) -> set[str]:
    """Function names of the kernels an ``nvcc -Xptxas -v`` report compiled
    ("Compiling entry function '<symbol>'")."""
    out = set()
    for m in re.finditer(r"Compiling entry function '([^']+)'", ptxas_report):
        sym = m.group(1)
        out.add(mangled_ident(sym) or sym)  # an extern "C" kernel keeps its name
    return out


def _union(intervals) -> list[tuple[float, float]]:
    merged = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            if e > merged[-1][1]:
                merged[-1][1] = e
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


class Trace:
    """Device operations of the traced ops (times in seconds)."""

    def __init__(self, ops: int, window: tuple, device_ops: list, host_ops: list, hand: set):
        self.ops = ops
        self.t0, self.t1 = window
        self.window_s = self.t1 - self.t0
        # (start, end, name) of every device operation inside the window
        self.device_ops = [(max(s, self.t0), min(e, self.t1), n) for s, e, n in device_ops
                           if e > self.t0 and s < self.t1]
        self.host_ops = host_ops  # (start, end, name) of host events
        self.hand = hand  # function names of the program's hand-written kernels
        self.busy = _union((s, e) for s, e, _ in self.device_ops)
        self.busy_s = sum(e - s for s, e in self.busy)

    def is_hand(self, name: str) -> bool:
        return kernel_ident(name) in self.hand

    def by_name(self) -> dict:
        out: dict = {}
        for s, e, n in self.device_ops:
            out[n] = out.get(n, 0.0) + (e - s)
        return out

    def seconds_where(self, pred) -> float:
        return sum(e - s for s, e, n in self.device_ops if pred(n))

    def gaps(self) -> list[tuple[float, float]]:
        out, t = [], self.t0
        for s, e in self.busy:
            if s > t:
                out.append((t, s))
            t = max(t, e)
        if self.t1 > t:
            out.append((t, self.t1))
        return out

    def host_label(self, t: float) -> str:
        """The innermost host event under way at time t, with the harness
        range it lies in."""
        best, rng = None, None
        for s, e, n in self.host_ops:
            if s <= t <= e:
                if n.startswith("bench/"):
                    if n != WINDOW and (rng is None or s >= rng[0]):
                        rng = (s, n)
                elif best is None or s >= best[0]:
                    best = (s, n)
        parts = [p[1] for p in (rng, best) if p is not None]
        return " > ".join(parts) if parts else "host idle"

    def breakdown(self, top: int = 10) -> dict:
        ops = sorted(self.by_name().items(), key=lambda kv: -kv[1])[:top]
        gaps = sorted(self.gaps(), key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": [[n, s] for n, s in ops],
                "idle_gaps": [[self.host_label((a + b) / 2), b - a] for a, b in gaps]}


def _collect(prof):
    from torch.autograd import DeviceType

    device_ops, host_ops, window = [], [], None
    for ev in prof.events():
        s, e = ev.time_range.start / 1e6, ev.time_range.end / 1e6
        if ev.device_type == DeviceType.CUDA:
            if not getattr(ev, "is_user_annotation", False) and e > s:
                device_ops.append((s, e, ev.name))
        else:
            host_ops.append((s, e, ev.name))
            if ev.name == WINDOW:
                window = (s, e)
    return device_ops, host_ops, window


def trace_ops(call, count: int, sync, hand: set, attempts: int = 3, agree=None) -> Trace:
    """``count`` calls of ``call(j)``, each synchronised by ``sync``, traced
    after one call that lets the profiler settle.  ``agree`` (a multi-rank
    cell's ``Ranks.all``) takes this rank's verdict on its trace and returns
    whether every rank's held device time, so that all ranks make the same
    calls."""
    from torch.profiler import ProfilerActivity, profile, record_function

    for _ in range(attempts):
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            sync(call(count))  # outside the window: the profiler's own start-up
            with record_function(WINDOW):
                for j in range(count):
                    with record_function(OP):
                        out = call(j)
                    with record_function(READ_BACK):
                        sync(out)
        device_ops, host_ops, window = _collect(prof)
        ok = window is not None and bool(device_ops)
        if (ok if agree is None else agree(ok)):
            return Trace(count, window, device_ops, host_ops, hand)
    raise RuntimeError(f"{attempts} traces held no device time")
