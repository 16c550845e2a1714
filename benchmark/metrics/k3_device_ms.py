"""Device milliseconds an op of K3, the point kernels (csrc/point*, chain*,
g2_*: G1 and Fq2 entries), from the profiler's trace."""

from benchmark.trace import kernel_ident

K3 = {"point_kernel", "point2_kernel", "horner_kernel", "scalar_mul_kernel", "ec_fft_stage_kernel",
      "lattice_kernel"}


def read(run):
    t = run.trace
    if t is None:
        return None
    s = t.seconds_where(lambda name: kernel_ident(name) in K3)
    return 1e3 * s / t.ops if s > 0 else None
