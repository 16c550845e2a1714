"""One MSM's work: Pippenger's, at its cheapest window; bytes: the affine
bases and the scalars in, one Jacobian point out."""

from benchmark.peaks import field_bytes, least, pippenger_products
from benchmark.reference.params import CURVES


def work(config: dict, traffic: dict) -> dict:
    c = CURVES[traffic["curve"]]
    n = 1 << traffic["log_n"]
    rb, qb = c.r.bit_length(), c.q.bit_length()
    fq = c.ext * field_bytes(qb)
    return least({qb: pippenger_products(n, rb, c.ext)}, n * (2 * fq + field_bytes(rb)) + 3 * fq)
