"""A batch's work: Pippenger's MSM of each chunk at its cheapest window;
bytes: every base row and scalar in, one Jacobian point a chunk out."""

from benchmark.peaks import field_bytes, least, pippenger_products
from benchmark.reference.params import CURVES


def work(config: dict, traffic: dict) -> dict:
    c = CURVES[traffic["curve"]]
    rows = (1 << traffic["base_log_n"]) * traffic["tile"]
    chunks = traffic["chunks"]
    rb, qb = c.r.bit_length(), c.q.bit_length()
    fq = c.ext * field_bytes(qb)
    products = chunks * pippenger_products(rows // chunks, rb, c.ext)
    return least({qb: products}, rows * (2 * fq + field_bytes(rb)) + chunks * 3 * fq)
