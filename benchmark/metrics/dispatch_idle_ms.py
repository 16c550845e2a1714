"""Device-idle milliseconds an op inside the program's spans but outside
every wait span: the card waiting for the program's host code between
launches (the gaps of ``Trace.gaps()`` inside any ``tpu_ec_torch/`` span,
less those inside a ``tpu_ec_torch/wait/`` span), over the traced ops.  None
where the trace holds no span of the program."""

from benchmark.metrics.wait_idle_ms import PREFIX, WAIT, has_spans, idle_inside, span_union


def read(run):
    t = run.trace
    if not has_spans(t):
        return None
    inside = idle_inside(t, span_union(t, PREFIX))
    return 1e3 * max(0.0, inside - idle_inside(t, span_union(t, WAIT))) / t.ops
