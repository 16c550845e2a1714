#!/usr/bin/env python3
"""Time the port's MSM paths, for comparing two checkouts on one GPU.

    PYTHONPATH=<checkout> python3 tpu_ec_torch/utils/time_paths.py [--log-n 20] [--g2]

Imports ``tpu_ec_torch`` from the first checkout on ``PYTHONPATH``, so one
copy of this script also times a checkout of another commit; run two
checkouts in one machine, in the order A, B, B, A, and compare them there.
Prints one JSON line: ms per call (host clock around synchronised calls,
three calls after a warm-up) of the BLS12-381 G1 commit at 2^n
(``CommitPipeline.commit``), the pair and co-Z MSMs on its scalars, and,
where the checkout has ``multiple_multiexp``, the AMT batch of 2^10-point
chunks over the same bases with fresh scalars; the card's name and power
limit; and whether the co-Z MSM equals the pair MSM (it exits 1 if not).
Inputs come from a seed: random Montgomery coefficients below r and 2^n
points k*G with random 64-bit k (the native C++ scalar multiplication).

``--g2`` times G2 instead: the BLS12-381 G2 MSM at 2^n ("auto", the scan
engine; bases k_i G2 with random 64-bit k_i, 2^16 of them tiled to 2^n,
which leaves the scan's work as it is; fresh Fr scalars), held equal to
(sum k_i s_i) G2, and the BN254 and BLS12-381 G2 EC-FFTs at 2^11 (2^n where
n < 11), forward and inverse, the inverse held equal to the input (it exits
1 if either is not).  ``--device cpu`` runs the same steps on the CPU, at a
small ``--log-n``.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time

SEED = 20240601


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--g2", action="store_true", help="time the G2 MSM and EC-FFTs instead")
    args = ap.parse_args()

    import numpy as np
    import torch

    import tpu_ec_torch
    from tpu_ec_torch.curves.params import BLS12_381_G1
    from tpu_ec_torch.fields.params import BLS12_381_FR
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.pipeline import CommitPipeline

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("time_paths: no CUDA device available", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    n = 1 << args.log_n
    rng = np.random.default_rng(SEED)

    def ms(fn):
        fn()
        out = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            fn()
            sync()
            out.append((time.perf_counter() - t0) * 1e3)
        return out

    res = {"package": tpu_ec_torch.__file__.rsplit("/", 2)[0], "log_n": args.log_n}
    if cuda:
        res["card"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
    if args.g2:
        ok = time_g2(res, dev, n, rng, ms)
        print(json.dumps(res), flush=True)
        return 0 if ok else 1

    L = BLS12_381_FR.n_limbs
    coeffs = rng.integers(0, 1 << 16, (n, L), dtype=np.int64)
    coeffs[:, -1] = rng.integers(0, int(BLS12_381_FR.p_limbs[-1]), n)  # below r's top limb
    nc = native_curve(BLS12_381_G1)
    G = nc.affine_from_points([(BLS12_381_G1.gen_x, BLS12_381_G1.gen_y)])
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    aff = nc.to_affine(nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks))

    pipe = CommitPipeline(BLS12_381_G1, device=dev)
    w = nc.w
    bases = pipe.msm.upload_bases(tuple(
        torch.as_tensor(nc.fq.to_halflimbs(aff[:, i * w : (i + 1) * w]).astype("int64")) for i in range(2)))
    coeffs = torch.as_tensor(coeffs).to(dev, pipe.ops.fq.dtype)
    evals, commitment = pipe.commit(coeffs, bases)
    scalars = pipe.fr.from_mont(evals)

    res.update({
        "commit_ms": ms(lambda: pipe.commit(coeffs, bases)),
        "pair_ms": ms(lambda: pipe.msm.multiexp(bases, scalars, method="pair")),
        "coz_ms": ms(lambda: pipe.msm.multiexp(bases, scalars, method="coz")),
        "amt_ms": None,
    })
    same = lambda p, q: all(torch.equal(x, y) for x, y in zip(pipe.ops.to_affine(p), pipe.ops.to_affine(q)))
    res["coz_equal"] = same(pipe.msm.multiexp(bases, scalars, method="coz"), commitment)
    if hasattr(pipe.msm, "multiple_multiexp"):
        chunk = 1 << min(10, args.log_n // 2)
        amt_s = rng.integers(0, 1 << 16, (n, L), dtype=np.int64)
        amt_s[:, -1] = rng.integers(0, int(BLS12_381_FR.p_limbs[-1]), n)
        amt_s = torch.as_tensor(amt_s).to(dev, pipe.ops.fq.dtype)
        res["amt_chunks"] = [chunk, n // chunk]
        res["amt_ms"] = ms(lambda: pipe.msm.multiple_multiexp(bases, amt_s, n // chunk))
    print(json.dumps(res), flush=True)
    return 0 if res["coz_equal"] else 1


def time_g2(res: dict, dev, n: int, rng, ms) -> bool:
    """The G2 steps of ``--g2`` into ``res``; False where an output is wrong."""
    import numpy as np
    import torch

    from tpu_ec_torch.curves.params import BLS12_381_G2, BN254_G2
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.ec_fft import EcFftKernel
    from tpu_ec_torch.ops.msm import MultiexpKernel

    def coords(nc, arr, k):
        w = nc.w
        return tuple(torch.as_tensor(nc.coord_to_halflimbs(arr[:, i * w : (i + 1) * w]).astype("int64"))
                     .to(dev, torch.int32) for i in range(k))

    def points(nc, m):
        G = nc.affine_from_points([(nc.spec.gen_x, nc.spec.gen_y)])
        ks = np.zeros((m, 4), dtype=np.uint64)
        ks[:, 0] = rng.integers(1, 1 << 63, m, dtype=np.uint64)
        return nc.scalar_mul(np.broadcast_to(G, (m, G.shape[1])).copy(), ks), ks[:, 0]

    nc = native_curve(BLS12_381_G2)
    base = min(n, 1 << 16)
    jac, ks = points(nc, base)
    msm = MultiexpKernel(BLS12_381_G2, dev)
    bases = msm.upload_bases(coords(nc, np.tile(nc.to_affine(jac), (n // base, 1)), 2))
    r = BLS12_381_G2.scalar.modulus
    s = rng.integers(0, 1 << 16, (n, 16), dtype=np.int64)
    s[:, -1] = rng.integers(0, r >> 240, n)  # below r
    scal = torch.as_tensor(s).to(dev, torch.int32)
    got = msm.ops.to_affine(msm.multiexp(bases, scal))
    # sum_i k_(i mod base) s_i: the scalars summed a base, then 16-bit pieces
    # of k against them in one int64 product (each sum < 2^52)
    sb = s.reshape(n // base, base, 16).sum(0)
    k16 = np.stack([(ks >> np.uint64(16 * a)) & np.uint64(0xFFFF) for a in range(4)], axis=1).astype(np.int64)
    m = k16.T @ sb
    total = sum(int(m[a, b]) << (16 * (a + b)) for a in range(4) for b in range(16)) % r
    want = nc.to_affine(nc.scalar_mul(nc.affine_from_points([(nc.spec.gen_x, nc.spec.gen_y)]),
                                      nc.scalars_from_ints([total])))
    res["g2_msm_equal"] = bool(np.array_equal(
        np.concatenate([nc.coord_from_halflimbs(c.cpu().numpy().astype(np.uint64)) for c in got], axis=1), want))
    res["g2_msm_ms"] = ms(lambda: msm.multiexp(bases, scal))
    lg = min(11, n.bit_length() - 1)
    res["g2_ec_fft_log_n"] = lg
    for curve in (BN254_G2, BLS12_381_G2):
        ncv = native_curve(curve)
        P = coords(ncv, points(ncv, 1 << lg)[0], 3)
        kern = EcFftKernel(curve, dev)
        out = kern.radix_ec_fft(P)
        back = kern.radix_ec_fft(out, inverse=True)
        same = all(torch.equal(a, b) for a, b in zip(kern.ops.to_affine(back), kern.ops.to_affine(P)))
        res[f"g2_ec_fft_{curve.name}_inverse_equal"] = same
        res[f"g2_ec_fft_{curve.name}_ms"] = ms(lambda: kern.radix_ec_fft(P))
        res[f"g2_ec_fft_{curve.name}_inverse_ms"] = ms(lambda: kern.radix_ec_fft(out, inverse=True))
    return res["g2_msm_equal"] and all(v for k, v in res.items() if k.endswith("_inverse_equal"))


if __name__ == "__main__":
    sys.exit(main())
