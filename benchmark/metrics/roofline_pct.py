"""The op's least time (benchmark/roofline, at the card's peaks) over its
device-busy time, in percent."""


def read(run):
    t = run.trace
    if t is None or t.busy_s <= 0 or run.work is None:
        return None
    return 100.0 * run.work["least_s"] / (t.busy_s / t.ops)
