"""The yardstick of the roofline: the card's peaks and the textbook work of
the ops, worked out from the inputs alone, never from what the program
launches.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at its 700 W
power limit): 1,979 TOP/s of int8, 3.35 TB/s of HBM, and the int32
multiply-add rate 132 SMs x 64 lanes x 1.98 GHz (boost clock).

A field product of b bits costs the cheaper of two routes: a Montgomery
product on w = ceil(b / 32) words, 2 w^2 + w multiply-adds at the int32
rate, or its (2 B^2 + B) int8 digit products (B = ceil(b / 8) bytes; each
a multiply and an add, 2 ops) at the int8 rate.  Point ops count field
products (an Fq2 product 3 Fq products, an Fq2 square 2): a = 0 Jacobian
doubling 2M + 5S (dbl-2009-l), addition 11M + 5S (add-2007-bl), mixed
addition 7M + 4S (madd-2007-bl).  The least time of an op is the larger of
its products' time and its bytes (inputs read once, outputs written once)
over the HBM bandwidth, so no implementation can beat it.
"""

from __future__ import annotations

import math

INT8_OPS_PER_S = 1979e12
HBM_BYTES_PER_S = 3.35e12
IMAD_PER_S = 132 * 64 * 1.98e9

# (products, squares) of each point op
POINT_OPS = {"dbl": (2, 5), "add": (11, 5), "madd": (7, 4)}


def product_s(bits: int) -> float:
    """Seconds of one field product of ``bits`` bits at the card's peak."""
    w, B = -(-bits // 32), -(-bits // 8)
    return min((2 * w * w + w) / IMAD_PER_S, 2 * (2 * B * B + B) / INT8_OPS_PER_S)


def point_products(op: str, ext: int) -> int:
    """Fq products of one point op on G1 (ext 1) or G2 (ext 2)."""
    m, s = POINT_OPS[op]
    return m + s if ext == 1 else 3 * m + 2 * s


def pippenger_products(n: int, bits: int, ext: int) -> int:
    """Fq products of Pippenger's MSM of n points with ``bits``-bit scalars
    at its cheapest window c, unsigned (2^c - 1 buckets) or signed digits
    (2^(c - 1) buckets, one more bit): per window n mixed adds into the
    buckets and 2 B adds of the running sums; then (windows - 1) times c
    doublings and an add to combine the windows."""
    madd, add, dbl = (point_products(o, ext) for o in ("madd", "add", "dbl"))
    best = None
    for c in range(1, 25):
        for signed in (0, 1):
            windows = -(-(bits + signed) // c)
            buckets = (1 << (c - 1)) if signed else (1 << c) - 1
            cost = windows * (n * madd + 2 * buckets * add) + (windows - 1) * (c * dbl + add)
            best = cost if best is None else min(best, cost)
    return best


def field_bytes(bits: int) -> int:
    return -(-bits // 8)


def least(products_by_bits: dict, nbytes: int) -> dict:
    """{bits: products} and the bytes moved -> the op's work and least time."""
    compute_s = sum(p * product_s(b) for b, p in products_by_bits.items())
    memory_s = nbytes / HBM_BYTES_PER_S
    return {"products": {str(b): p for b, p in products_by_bits.items()}, "bytes": nbytes,
            "compute_s": compute_s, "memory_s": memory_s, "least_s": max(compute_s, memory_s),
            "bound": "compute" if compute_s >= memory_s else "memory"}


def log2(n: int) -> int:
    k = int(math.log2(n))
    if 1 << k != n:
        raise ValueError(f"{n} is not a power of two")
    return k
