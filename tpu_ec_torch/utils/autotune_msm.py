#!/usr/bin/env python3
"""Measure the best MSM window per curve, engine and size on the card, and
write the table ``ops/autotune.tuned_window`` reads.

    python3 -m tpu_ec_torch.utils.autotune_msm [--out PATH] [--rows CURVE:ENGINE:LOG_N ...]

The H100 counterpart of ``scripts/autotune_msm_tpu.py``.  For each row
(default: BLS12-381 G1 ``pair`` at 2^14, 2^16, 2^18, 2^20 and 2^22, G1
``scan`` at 2^14, BLS12-381 G2 ``pair`` and ``scan`` at 2^16 and 2^20) it times
``MultiexpKernel.multiexp`` at every window within 2 of the engine's
model (in [2, 20]): one warm-up call each, then the mean of three calls
each (host clock around synchronised calls), timed in three rounds over
the windows so that a drift of the host falls on every window alike.  A
row takes the fastest window only where it beats the model's window by
more than the spread (slowest less fastest run) of either; otherwise the
row is the model's window, and the output says the row is within noise.
A window whose working set does not fit in device memory is skipped
(noted in the output).  Every output
must equal the native C++ Pippenger (``native.NativeCurve.msm``) on the
same inputs, or the script exits 1 and writes nothing.  Inputs come from a
seed: 2^16 points k G with random 64-bit k (the native scalar
multiplication) tiled to n, and random scalars below r.

The table (default ``tpu_ec_torch/ops/tuned_windows.json``; ``--out``
writes it elsewhere, to be copied into the package) is
{curve: {engine: {log2 n: best window}}}; rows of the file that this run
does not measure stay as they are.  Its top-level ``"_card"`` is the card's
name and power limit (``nvidia-smi --query-gpu=name,power.limit``).  The
last line printed is a JSON object of every time measured.  ``--device
cpu`` runs the same steps on the CPU, at small ``--rows``, with no card
line (a rehearsal; it writes no table unless ``--out`` is given).
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

SEED = 20240601
SPAN = 2  # windows within this of the model's
DEFAULT_ROWS = ("bls12_381_g1:pair:14", "bls12_381_g1:pair:16", "bls12_381_g1:pair:18", "bls12_381_g1:pair:20",
                "bls12_381_g1:pair:22", "bls12_381_g1:scan:14", "bls12_381_g2:pair:16", "bls12_381_g2:pair:20",
                "bls12_381_g2:scan:16", "bls12_381_g2:scan:20")
DISTINCT = 1 << 16  # distinct points, tiled to n


def model_window(engine: str, n: int) -> int:
    from tpu_ec_torch.ops.msm_coz import default_window_size_coz
    from tpu_ec_torch.ops.msm_pair import default_window_size_pair
    from tpu_ec_torch.ops.msm_scan import default_window_size_scan

    return {"pair": default_window_size_pair, "scan": default_window_size_scan, "coz": default_window_size_coz}[
        engine](n)


def native_msm(nc, aff, s):
    """The native Pippenger of (n, 2w) affine u64 points and (n, 16)
    half-limb scalars, affine."""
    import numpy as np

    return nc.to_affine(nc.msm(aff, nc.fr.from_halflimbs(s.astype(np.uint64)))[None, :])


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="the table to write (default: the package's tuned_windows.json)")
    ap.add_argument("--rows", nargs="+", default=list(DEFAULT_ROWS), help="CURVE:ENGINE:LOG_N rows to measure")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args()

    import numpy as np
    import torch

    from tpu_ec_torch import curves
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops import autotune
    from tpu_ec_torch.ops.msm import MultiexpKernel

    dev = torch.device(args.device)
    cuda = dev.type == "cuda"
    if cuda and not torch.cuda.is_available():
        print("autotune_msm: no CUDA device available", file=sys.stderr)
        return 1
    sync = torch.cuda.synchronize if cuda else (lambda: None)
    out_path = args.out or (autotune._TABLE_PATH if cuda else None)
    card = None
    if cuda:
        card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                              capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]
        print(f"card: {card} | {torch.cuda.get_device_name(0)}", flush=True)
    rng = np.random.default_rng(SEED)
    results, best, verdicts = [], {}, []

    def timed(fn):
        sync()
        t0 = time.perf_counter()
        fn()
        sync()
        return (time.perf_counter() - t0) * 1e3

    inputs = {}
    # the native Pippenger runs beside the card (ctypes frees the GIL)
    with ThreadPoolExecutor(1) as referee:
        for row in args.rows:
            curve, engine, log_n = row.split(":")
            n = 1 << int(log_n)
            spec = getattr(curves, curve.upper())
            nc = native_curve(spec)
            if curve not in inputs:  # up to DISTINCT points k G of this curve, affine, native layout
                m = min(DISTINCT, max(1 << int(r.split(":")[2]) for r in args.rows if r.startswith(curve + ":")))
                G = nc.affine_from_points([(spec.gen_x, spec.gen_y)])
                ks = np.zeros((m, 4), dtype=np.uint64)
                ks[:, 0] = rng.integers(1, 1 << 63, m, dtype=np.uint64)
                inputs[curve] = nc.to_affine(nc.scalar_mul(np.broadcast_to(G, (m, G.shape[1])).copy(), ks))
            aff = np.tile(inputs[curve], (-(-n // len(inputs[curve])), 1))[:n]
            s = rng.integers(0, 1 << 16, (n, 16), dtype=np.int64)
            s[:, -1] = rng.integers(0, spec.scalar.modulus >> 240, n)  # below r
            want = referee.submit(native_msm, nc, aff, s)
            kern = MultiexpKernel(spec, dev)
            w = nc.w
            bases = kern.upload_bases(tuple(torch.as_tensor(nc.coord_to_halflimbs(aff[:, i * w : (i + 1) * w])
                                                            .astype(np.int64)) for i in range(2)))
            scal = torch.as_tensor(s).to(dev, torch.int32)
            w0 = model_window(engine, n)
            outs, times, spread = [], {}, {}
            call = lambda win: kern.multiexp(bases, scal, window_size=win, method=engine)
            for win in range(max(2, w0 - SPAN), min(20, w0 + SPAN) + 1):  # the warm-ups and outputs
                try:
                    got = kern.ops.to_affine(call(win))
                except torch.cuda.OutOfMemoryError:
                    torch.cuda.empty_cache()
                    print(f"{curve} {engine} 2^{log_n} w={win}: does not fit in device memory, skipped", flush=True)
                    continue
                outs.append((win, np.concatenate([nc.coord_from_halflimbs(c.cpu().numpy().astype(np.uint64))
                                                  for c in got], axis=1)))
            # three rounds over the windows, so that a drift of the host falls on every window alike
            runs = {win: [] for win, _ in outs}
            for _ in range(3):
                for win in runs:
                    runs[win].append(timed(lambda: call(win)))
            for win, r in runs.items():
                times[win], spread[win] = sum(r) / 3, max(r) - min(r)
                print(f"{curve} {engine} 2^{log_n} w={win}: {times[win]:.3f} ms mean of 3 "
                      f"({', '.join(f'{t:.3f}' for t in r)}), {n / times[win] * 1e-3:.4f} M points/s", flush=True)
                results.append({"curve": curve, "engine": engine, "log_n": int(log_n), "window": win,
                                "ms": times[win], "runs": r, "model": win == w0})
            ref = want.result()
            bad = [win for win, o in outs if not np.array_equal(o, ref)]
            if bad or not times:
                print(f"{curve} {engine} 2^{log_n}: windows {bad} disagree with the native Pippenger, "
                      f"or none ran", file=sys.stderr)
                return 1
            fastest = min(times, key=times.get)
            # the fastest counts only where its gain exceeds both windows' run spreads
            noise = w0 in times and times[w0] - times[fastest] <= max(spread[w0], spread[fastest])
            pick = w0 if noise else fastest
            best.setdefault(curve, {}).setdefault(engine, {})[log_n] = pick
            verdicts.append({"curve": curve, "engine": engine, "log_n": int(log_n), "model": w0,
                             "fastest": fastest, "window": pick, "within_noise": bool(noise and fastest != w0)})
            note = " (within noise: the model's)" if verdicts[-1]["within_noise"] else ""
            print(f"{curve} {engine} 2^{log_n}: every window == native Pippenger; fastest w={fastest} "
                  f"({times[fastest]:.3f} ms, spread {spread[fastest]:.3f}), model w={w0} "
                  f"({times.get(w0, float('nan')):.3f} ms, spread {spread.get(w0, float('nan')):.3f}); "
                  f"row w={pick}{note} | {card}", flush=True)
            del bases, scal, kern
            if cuda:
                torch.cuda.empty_cache()

    if out_path:
        table = {}
        if os.path.exists(out_path):
            with open(out_path) as fh:
                table = json.load(fh)
        if card:
            table["_card"] = card
        for curve, engines in best.items():
            for engine, rows in engines.items():
                table.setdefault(curve, {}).setdefault(engine, {}).update(rows)
        os.makedirs(os.path.dirname(os.path.abspath(out_path)), exist_ok=True)
        with open(out_path, "w") as fh:
            json.dump(table, fh, indent=1, sort_keys=True)
            fh.write("\n")
        print(f"wrote {out_path}", flush=True)
    print(json.dumps({"card": card, "best": best, "rows": verdicts, "measured": results}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
