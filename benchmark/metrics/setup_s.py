"""Seconds from the start of benchmark/run.py to the first timed op: the
imports, the kernels' build or its cache, the inputs, the warm-up."""


def read(run):
    return run.setup_s
