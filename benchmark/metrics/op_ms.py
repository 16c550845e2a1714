"""Milliseconds an op: the window's wall time over the ops completed in it."""


def read(run):
    return 1e3 * run.window_s / run.ops if run.ops else None
