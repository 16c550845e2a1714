"""Device milliseconds an op of every device operation that is not one of
the program's hand-written kernels (gathers, scatters, cat, roll, copies,
the int8 GEMM), from the profiler's trace."""


def read(run):
    t = run.trace
    if t is None or not t.hand:
        return None
    return 1e3 * t.seconds_where(lambda name: not t.is_hand(name)) / t.ops
