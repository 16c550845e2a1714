#!/usr/bin/env python3
"""Time K3's lattice entry (``csrc/chain.cuh`` ``lattice_kernel``) on the card
at the bucket lattice's shapes and at fewer lanes.  On no path; for finding
what holds the entry back from its serial bound.

    python3 -m tpu_ec_torch.utils.lattice_probe [--g1-groups G ...] [--g2-groups G ...]

Run from the repository root: it takes chip_smoke.py's helpers.  On
BLS12-381, with points k G (random 64-bit k, native scalar multiplication)
and random Fr scalars, the operands built as ``msm_lattice`` builds them,
it prints one JSON line a case: curve, window, groups, steps, lanes, warps
(tiles of ``chain_tile`` lanes, 32 threads a warp), the entry's device ms
(CUDA events, mean of 5 after a warm-up), the busiest lane's product levels
(``chip_smoke.lattice_work``), their serial bound at one product's latency
(``mul_chain``), and ms over it.  Cases: the G1 2^16 unsigned lattice (w
6, 512 steps) at the path's G = 128 and at each ``--g1-groups`` (default
16, 32, 64: fewer lanes, the same chains); ``multiexp_1bit``'s (w 1, G 16,
4096 steps); the G2 2^12 unsigned lattice (w 2, 128 steps) at the path's G
= 32 and at each ``--g2-groups`` (default 8, 16); the BN254 G1 2^16
unsigned lattice (8 words) at G = 128 and 16.  Then the card's name and
power limit.
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

import chip_smoke as cs
from tpu_ec_torch.curves.params import BLS12_381_G1, BLS12_381_G2, BN254_G1
from tpu_ec_torch.fields.params import BLS12_381_FR, BN254_FR
from tpu_ec_torch.kernels.point import chain_tile, lattice_lanes, mul_chain
from tpu_ec_torch.native import native_curve
from tpu_ec_torch.ops.msm import SCALAR_BITS, make_digits, prepare_inputs


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--g1-groups", type=int, nargs="*", default=[16, 32, 64])
    ap.add_argument("--g2-groups", type=int, nargs="*", default=[8, 16])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("lattice_probe: no CUDA device")
    dev = torch.device("cuda")
    card = cs.card_line()
    rng = np.random.default_rng(cs.SEED + 7)
    lat = {}  # one product's latency on one thread, by the field's words
    for fq in (BN254_G1.base, BLS12_381_G1.base):
        a, b = (torch.as_tensor(cs.random_field(rng, fq, 4)[3]).to(dev, torch.int32) for _ in range(2))
        lat[fq.n_limbs // 2] = cs.cuda_ms(lambda: mul_chain(fq, a, b, 1 << 14)) / (1 << 14)
    cases = [(BLS12_381_G1, 6, 512, G) for G in [128, *args.g1_groups]] + [(BLS12_381_G1, 1, 4096, 16)]
    cases += [(BLS12_381_G2, 2, 128, G) for G in [32, *args.g2_groups]]
    cases += [(BN254_G1, 6, 512, G) for G in (128, 16)]
    pts = {}
    for spec in (BLS12_381_G1, BLS12_381_G2, BN254_G1):
        nc = native_curve(spec)
        most = max(m * G for sp, _, m, G in cases if sp is spec)
        pts[spec.name] = cs.coords_from_u64(nc, cs.random_points(nc, rng, most)[1], 2, dev)
    for spec, w, m, G in cases:
        n = m * G
        bases = tuple(c[:n] for c in pts[spec.name])
        fr = BN254_FR if spec is BN254_G1 else BLS12_381_FR
        scal = torch.as_tensor(cs.random_field(rng, fr, n)).to(dev, torch.int32)
        (x, y), s, _ = prepare_inputs(bases, scal, G)
        W = -(-SCALAR_BITS // w)
        digits = make_digits(s.reshape(m * G, -1), w, W, False).reshape(m, G * W)
        nb = 1 << w  # unsigned: slots 1 .. 2^w - 1, and tpu_ec's dummy slot 0
        ms = cs.cuda_ms(lambda: lattice_lanes(spec.base, x, y, digits, nb, False, spec.ext))
        levels, _ = cs.lattice_work(digits, nb, spec.ext)
        serial = levels * lat[spec.base.n_limbs // 2]
        tile = chain_tile(spec.base, spec.ext)
        print(json.dumps({"curve": spec.name, "w": w, "groups": G, "steps": m, "lanes": G * W,
                          "warps": -(-G * W * tile // 32), "ms": round(ms, 4), "levels": levels,
                          "serial_ms": round(serial, 4), "ms_over_serial": round(ms / serial, 3)}), flush=True)
    print(card, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
