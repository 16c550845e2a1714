"""Device-idle milliseconds an op inside the program's wait spans: the
gaps between device operations on the profiler's timeline
(``Trace.gaps()``) that lie inside a ``tpu_ec_torch/wait/<site>`` span, a
call of the program that blocks the host on the card, over the traced ops.
None where the trace holds no span of the program at all, so that a
program without spans shows as a missing metric, not as 0."""

PREFIX = "tpu_ec_torch/"
WAIT = PREFIX + "wait/"


def span_union(trace, prefix: str) -> list[tuple[float, float]]:
    """The union of the host spans whose name starts with ``prefix``, as
    sorted disjoint (start, end) intervals."""
    merged: list[list[float]] = []
    for s, e in sorted((s, e) for s, e, n in trace.host_ops if n.startswith(prefix)):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def idle_inside(trace, intervals) -> float:
    """Seconds of the trace's device gaps inside sorted disjoint
    ``intervals``."""
    total, j = 0.0, 0
    for a, b in trace.gaps():
        while j < len(intervals) and intervals[j][1] <= a:
            j += 1
        k = j
        while k < len(intervals) and intervals[k][0] < b:
            total += min(b, intervals[k][1]) - max(a, intervals[k][0])
            k += 1
    return total


def has_spans(trace) -> bool:
    return trace is not None and trace.ops > 0 and any(n.startswith(PREFIX) for _, _, n in trace.host_ops)


def read(run):
    t = run.trace
    if not has_spans(t):
        return None
    return 1e3 * idle_inside(t, span_union(t, WAIT)) / t.ops
