"""A commit's work: the NTT's (n/2) log2 n Fr products, from_mont's n, and
Pippenger's G1 MSM of n points; bytes: the coefficients and the affine
bases in, the evaluations and the commitment out."""

from benchmark.peaks import field_bytes, least, pippenger_products
from benchmark.reference.params import CURVES


def work(config: dict, traffic: dict) -> dict:
    c = CURVES[traffic["curve"]]
    n, log_n = 1 << traffic["log_n"], traffic["log_n"]
    rb, qb = c.r.bit_length(), c.q.bit_length()
    fr, fq = field_bytes(rb), c.ext * field_bytes(qb)
    nbytes = n * fr + n * 2 * fq + n * fr + 3 * fq
    return least({rb: (n // 2) * log_n + n, qb: pippenger_products(n, rb, c.ext)}, nbytes)
