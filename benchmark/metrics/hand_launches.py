"""Launches of the program's hand-written kernels an op, over the window
(tpu_ec_torch.kernels.launch_counters, an exact count)."""


def read(run):
    return sum(run.launches.values()) / run.ops if run.ops and run.launches else None
