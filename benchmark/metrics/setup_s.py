"""Seconds from the start of benchmark/run.py to the first timed op: the
imports, the kernels' build or its cache, the inputs, the warm-up; on a
multi-rank cell rank 0's, the other ranks' spawn and start included."""


def read(run):
    return run.setup_s
