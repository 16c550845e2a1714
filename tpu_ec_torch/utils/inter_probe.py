#!/usr/bin/env python3
"""Time kernel K2 (``csrc/inter.cu``) on the card, and build variants of it.
On no path; for choosing the int8 entry's design and for comparing two
checkouts on one card.

    PYTHONPATH=<checkout> python3 tpu_ec_torch/utils/inter_probe.py [--tiles T ...] [--no-ntt]

Imports ``tpu_ec_torch`` from the first checkout on ``PYTHONPATH`` and
builds that checkout's kernels.  Prints, with the card's name and power
limit, K2's registers and spills (``-Xptxas -v``) and its device time
(CUDA events over 20 launches after a warm-up) at the shapes the digit NTT
gives it, on BLS12-381 Fr:

- the int8 entry, the final pass of a chunked transform: (37, n) int8
  digits x one constant twiddle -> canonical (n, 16) rows, at n = 2^26 and
  2^20, and at 2^26 into (16, n) planes;
- the int32 entry at level 0 of the 2^20 plan: (40, 2^20) columns x the
  level's (n2 n1, 16) twiddle rows -> int8 digits;
- unless ``--no-ntt``, K2's device time over one forward 2^26 transform
  (torch.profiler, the launches whose name holds ``inter``) and its ms.

Each ``--tiles`` T builds a copy of the checkout's ``csrc/inter.cu`` with
the int8 kernel's tile (``kI8Tile``, columns a block) patched to T (a
multiple of 16, at most 256) into a library of its own, and times its
int8 entry at the same shapes, each output held bit-equal to the
checkout's library's.  The last line printed is a JSON object of every
number.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import subprocess
import sys
import tempfile

SEED = 20240601
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet


def card_line() -> str:
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def ptxas_lines(report: str) -> list[str]:
    """Registers and spills of the K2 kernels in a ``-Xptxas -v`` report."""
    out, name = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
        elif name and "inter" in name and ("registers" in ln or "spill" in ln):
            out.append(f"{name}: {ln.split(':', 2)[-1].strip()}")
    return out


TILE_LINE = "constexpr int kI8Tile = 256;"


def build_variant(build, tile: int, workdir: str, name: str):
    """The checkout's inter.cu alone, its int8 tile patched to ``tile`` -> (library, ptxas report)."""
    with open(os.path.join(build.CSRC, "inter.cu")) as fh:
        text = fh.read()
    if TILE_LINE not in text:
        raise SystemExit(f"variant {name}: no '{TILE_LINE}' in this checkout's inter.cu")
    src = os.path.join(workdir, f"inter_{name}.cu")
    with open(src, "w") as fh:
        fh.write(text.replace(TILE_LINE, f"constexpr int kI8Tile = {tile};"))
    so = os.path.join(workdir, f"inter_{name}.so")
    res = subprocess.run([build._nvcc(), *build.FLAGS, f"-I{build.CSRC}", "-shared", "-o", so, src],
                         capture_output=True, text=True, timeout=600)
    if res.returncode:
        raise SystemExit(f"variant {name}: nvcc failed\n{res.stderr[-3000:]}")
    lib = ctypes.CDLL(so)
    vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    lib.tec_inter.argtypes = [vp, i32, i32, vp, i32, i64, vp, i32, i32, i64, vp, vp]
    lib.tec_inter.restype = i32
    return lib, res.stderr


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--tiles", nargs="*", type=int, default=[], help="int8 tile sizes of inter.cu to build and time")
    ap.add_argument("--no-ntt", action="store_true", help="skip the 2^26 transform")
    args = ap.parse_args()

    import numpy as np
    import torch

    import tpu_ec_torch
    from tpu_ec_torch.fields.params import BLS12_381_FR
    from tpu_ec_torch.kernels import build
    from tpu_ec_torch.kernels.inter import inter_twiddle
    from tpu_ec_torch.ops import ntt_digit as nd

    if not torch.cuda.is_available():
        print("inter_probe: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line()
    res = {"package": os.path.dirname(os.path.abspath(tpu_ec_torch.__file__)), "card": card}
    print(f"card: {card} | {res['package']}", flush=True)
    build.load()
    res["ptxas"] = ptxas_lines(build.ptxas_report())
    for ln in res["ptxas"]:
        print(f"ptxas: {ln}", flush=True)
    dev = torch.device("cuda")
    spec = BLS12_381_FR
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    dom20 = nd.get_digit_domain(spec, 20, False, nd.leaf_log(20))
    c = torch.as_tensor(dom20.final_c.astype(np.int64)).to(dev, torch.int32)
    shapes = {}
    for log_n in (26, 20):
        dig = torch.randint(0, 128, (37, 1 << log_n), generator=gen, device=dev, dtype=torch.int8)
        shapes[f"i8_rows_2^{log_n}"] = (dig, True)
        if log_n == 26:
            shapes[f"i8_planes_2^{log_n}"] = (dig, False)
    kw = dict(canonical=True, const_t=True)
    refs = {}
    for name, (dig, rows) in shapes.items():
        n = dig.shape[1]
        refs[name] = inter_twiddle(spec, dig, c, out_rows=rows, **kw)
        ms = cuda_ms(lambda: inter_twiddle(spec, dig, c, out_rows=rows, **kw))
        bound = n * (37 + 64) / HBM_BYTES_PER_S * 1e3
        res[name] = {"ms": ms, "bound_ms": bound}
        print(f"K2 int8 entry {name}: {ms:.4f} ms, bytes bound {bound:.4f} ms, x{ms / bound:.2f} | {card}",
              flush=True)

    # the int32 entry at level 0 of the 2^20 plan, as chip_smoke.py's phase 3 runs it
    consts = nd.digit_consts(dom20, dev)
    lf = dom20.plan[0]
    T = consts["inter"][(20, 20 - lf)].view(-1, 16)
    col_bound = (1 << max(dom20.plan)) * dom20.d_in * 127 * 127
    cols = torch.randint(0, col_bound, (dom20.d_leaf, 1 << 20), generator=gen, device=dev, dtype=torch.int64)
    cols = cols.to(torch.int32)
    ms = cuda_ms(lambda: inter_twiddle(spec, cols, T, t_rep=1))
    bound = (1 << 20) * (dom20.d_leaf * 4 + 64 + 37) / HBM_BYTES_PER_S * 1e3
    res["i32_level0_2^20"] = {"ms": ms, "bound_ms": bound, "shape": [dom20.d_leaf, 1 << 20]}
    print(f"K2 int32 entry level 0 ({dom20.d_leaf}, 2^20) x T rows {tuple(T.shape)}: {ms:.4f} ms, bytes bound "
          f"{bound:.4f} ms, x{ms / bound:.2f} | {card}", flush=True)
    del cols, consts

    if not args.no_ntt:
        from torch.autograd import DeviceType
        from torch.profiler import ProfilerActivity, profile

        from tpu_ec_torch.ops.ntt import FftKernel

        x = torch.randint(0, 1 << 16, (1 << 26, 16), generator=gen, device=dev, dtype=torch.int32)
        x[:, -1] = torch.randint(0, int(spec.p_limbs[-1]), (1 << 26,), generator=gen, device=dev, dtype=torch.int32)
        k = FftKernel(spec, dev)
        k.radix_fft(x)  # the tables
        ntt_ms = cuda_ms(lambda: k.radix_fft(x), iters=3)
        for _ in range(3):  # a trace at times holds no device time: trace again
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                k.radix_fft(x)
                torch.cuda.synchronize()
            evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
            if sum(e.self_device_time_total for e in evs) > 0:
                break
        k2 = [e for e in evs if "inter" in e.key]
        res["ntt_2^26"] = {"ms": ntt_ms, "k2_ms": sum(e.self_device_time_total for e in k2) / 1e3,
                           "k2_launches": sum(e.count for e in k2)}
        print(f"NTT 2^26 forward: {ntt_ms:.3f} ms; K2 {res['ntt_2^26']['k2_ms']:.4f} ms of device time in "
              f"{res['ntt_2^26']['k2_launches']} launches | {card}", flush=True)
        del x, k

    with tempfile.TemporaryDirectory() as work:
        for tile in args.tiles:
            name = f"tile{tile}"
            lib, report = build_variant(build, tile, work, name)
            row = {"tile": tile, "ptxas": ptxas_lines(report)}
            for ln in row["ptxas"]:
                print(f"ptxas {name}: {ln}", flush=True)
            for shape, (dig, rows) in shapes.items():
                n = dig.shape[1]
                out = torch.empty((n, 16) if rows else (16, n), dtype=torch.int32, device=dev)

                def launch():
                    err = lib.tec_inter(dig.data_ptr(), 37, 1, c.data_ptr(), 1, 1, out.data_ptr(), 1, int(rows), n,
                                        build.field_consts(spec), build.stream())
                    if err:
                        raise SystemExit(f"variant {name}: CUDA error {err}")

                launch()
                torch.cuda.synchronize()
                if not torch.equal(out, refs[shape]):
                    raise SystemExit(f"variant {name}: {shape} differs from the library's output")
                ms = cuda_ms(launch)
                row[shape] = ms
                print(f"variant {name} {shape}: {ms:.4f} ms, x{ms / res[shape]['bound_ms']:.2f} of its "
                      f"bound, == the library's | {card}", flush=True)
            res.setdefault("variants", {})[name] = row
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
