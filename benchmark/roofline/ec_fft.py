"""An EC-FFT batch's work: every butterfly's two point adds and its scalar
multiplication by the twiddle, double-and-add over the twiddle's own bits
((bits - 1) doublings and (ones - 1) adds; none for the twiddle 1).  Stage s
of a 2^k transform uses w^(j 2^s), j < 2^(k - s - 1), each 2^s times.
Bytes: the Jacobian points in and out."""

from benchmark.peaks import field_bytes, least, point_products
from benchmark.reference.params import CURVES


def work(config: dict, traffic: dict) -> dict:
    c = CURVES[traffic["curve"]]
    log_n, batch = traffic["log_n"], traffic["transforms"]
    n = 1 << log_n
    add, dbl = point_products("add", c.ext), point_products("dbl", c.ext)
    omega = c.root_of_unity(log_n)
    per = 0
    for s in range(log_n):
        for j in range(n >> (s + 1)):
            w = pow(omega, j << s, c.r)
            chain = (w.bit_length() - 1) * dbl + (bin(w).count("1") - 1) * add
            per += (1 << s) * (2 * add + chain)
    qb = c.q.bit_length()
    pts = batch * n * 3 * c.ext * field_bytes(qb)
    return least({qb: batch * per}, 2 * pts)
