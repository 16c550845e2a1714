"""Builds an op: the program's ``tpu_ec_torch/build/<what>`` spans (a cache
miss that builds the kernel library, a table or a domain) that start inside
the traced window, over the traced ops; 0 when every cache hits.  None where
the trace holds no span of the program."""

from benchmark.metrics.wait_idle_ms import PREFIX, has_spans

BUILD = PREFIX + "build/"


def read(run):
    t = run.trace
    if not has_spans(t):
        return None
    return sum(1 for s, _, n in t.host_ops if n.startswith(BUILD) and t.t0 <= s <= t.t1) / t.ops
