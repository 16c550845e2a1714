"""The readers of the program's spans (wait_idle_ms, dispatch_idle_ms,
builds_per_op) on hand-built traces: a device gap inside a wait span, one
inside a stage span, one outside both, and a trace without program spans."""

from types import SimpleNamespace

import pytest

from benchmark import run as R
from benchmark.trace import Trace

READERS = ("wait_idle_ms", "dispatch_idle_ms", "builds_per_op")


def read(name, trace):
    return R.load_module("metrics", name).read(SimpleNamespace(trace=trace))


def trace(host, ops=2, window=(0.0, 10.0)):
    """Device busy on [0, 1], [3, 4], [6, 7] and [9, 10]: gaps (1, 3), (4, 6)
    and (7, 9), seconds."""
    device = [(0.0, 1.0, "k"), (3.0, 4.0, "k"), (6.0, 7.0, "k"), (9.0, 10.0, "k")]
    return Trace(ops, window, device, [(0.0, 10.0, "bench/window")] + host, set())


def test_a_gap_inside_a_wait_span_is_wait_idle():
    t = trace([(0.5, 3.5, "tpu_ec_torch/msm_batch"), (0.6, 3.4, "tpu_ec_torch/msm_batch/slab_size"),
               (1.5, 3.2, "tpu_ec_torch/wait/mem_get_info"), (1.5, 3.2, "cudaMemGetInfo")])
    assert read("wait_idle_ms", t) == pytest.approx(1e3 * 1.5 / 2)
    assert read("dispatch_idle_ms", t) == pytest.approx(1e3 * 0.5 / 2)  # (1, 1.5) of the gap
    assert read("builds_per_op", t) == 0


def test_a_gap_inside_a_stage_span_is_dispatch_idle():
    t = trace([(3.5, 6.5, "tpu_ec_torch/msm"), (4.2, 5.0, "tpu_ec_torch/msm/pair/round"),
               (5.0, 5.8, "tpu_ec_torch/msm/pair/round"), (5.1, 5.2, "tpu_ec_torch/wait/borrow_test")])
    assert read("dispatch_idle_ms", t) == pytest.approx(1e3 * (2.0 - 0.1) / 2)
    assert read("wait_idle_ms", t) == pytest.approx(1e3 * 0.1 / 2)


def test_a_gap_outside_every_span_reads_nothing():
    t = trace([(3.2, 3.8, "tpu_ec_torch/ec_fft"), (3.3, 3.4, "tpu_ec_torch/ec_fft/stage"),
               (7.2, 8.8, "bench/read_back"), (7.3, 8.7, "cudaStreamSynchronize")])
    assert read("wait_idle_ms", t) == 0 and read("dispatch_idle_ms", t) == 0


def test_builds_inside_the_window_count():
    t = trace([(-2.0, -1.0, "tpu_ec_torch/build/kernels"), (0.2, 0.9, "tpu_ec_torch/commit"),
               (0.3, 0.4, "tpu_ec_torch/build/digit_consts"), (0.5, 0.6, "tpu_ec_torch/build/window_table")],
              ops=4)
    assert read("builds_per_op", t) == 0.5


@pytest.mark.parametrize("name", READERS)
def test_no_program_span_is_no_metric(name):
    """A program that emits no span (the parent of this instrumentation)
    gives no number, not 0; nor does a run without a trace."""
    t = trace([(0.5, 3.5, "bench/op"), (1.5, 2.5, "cudaMemGetInfo"), (1.6, 1.7, "aten::cat")])
    assert read(name, t) is None
    assert read(name, None) is None
