#!/usr/bin/env python3
"""Time the digit NTT's leaf GEMM (``torch._int_mm``) by the layout of its
data operand, and the int8 copies that make that operand.  On no path; for
choosing the operand's layout.

    python3 tpu_ec_torch/utils/leaf_gemm_probe.py [--out PATH] [--small --device cpu]

Prints, with the card's name and power limit:

- for each GEMM shape the transforms of 2^27 (chunked) and 2^20 run,
  (rows x K) @ (K x N) int8 -> int32: the data operand row-major, (K, N)
  with N contiguous ("n_major", which cuBLASLt takes as an NN product),
  and K-major, a contiguous (N, K) tensor passed as its ``.t()``
  ("k_major", TN), and K-major with the digits of a row padded from 37 to
  40 ("k_major_d40", 8 % more work): device ms (CUDA events), the share of
  the card's 1,979 TOP/s int8 peak, and the kernels torch.profiler names;
  both layouts' products are held equal;
- for each level boundary of those transforms, the int8 copies that make
  the next level's operand from K2's (d, k2, j1, M) digit planes: the
  transpose and ``permute(1, 0, 2)`` of a row-major operand, against one
  permuted byte copy into the K-major (j1', k2, M, j2', d) operand, and
  against the engine's copy by words (``ntt_digit._to_kmajor``), whole and
  in the 16 slices of k2 of a chunked level;
- the first level from (n, 16) limb rows: the transposed-block split into
  planes and ``permute(1, 0, 2)`` of a row-major operand, against the
  engine's ``_split_first`` into K-major rows.

The last line printed is a JSON object of every number.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys

SEED = 20261018
INT8_PEAK_OPS = 1.979e15  # H100 SXM data sheet, dense int8
D_IN = 37  # base-2^7 digits of a 256-bit input

# (label, rows, m, N): rows of A2 (d_out * leaf outputs), leaf size m (K = m * D_IN), GEMM columns
GEMMS = [
    ("2^27 level slice", 296, 128, 1 << 20),
    ("2^27 final slice", 2368, 64, 1 << 17),
    ("2^20 level", 4736, 128, 1 << 13),
    ("2^20 last level", 2368, 64, 1 << 14),
]
# (label, n2, n2', n1', M): K2's planes (D_IN, n2, n2' n1', M) -> the next level's operand
LEVELS = [
    ("2^27 level 0 -> 1", 128, 128, 1 << 13, 1),
    ("2^27 level 1 -> 2", 128, 128, 64, 128),
    ("2^27 level 2 -> final", 128, 64, 1, 1 << 14),
    ("2^20 level 0 -> 1", 128, 128, 64, 1),
    ("2^20 level 1 -> final", 128, 64, 1, 128),
]
# (label, n2, n1): the first level's split of (n2 n1, 16) rows
FIRST = [("2^27 level 0", 128, 1 << 20), ("2^20 level 0", 128, 1 << 13)]
SMALL = 1 << 6  # --small divides every N, n1' or n1 (and M) by up to this


def card_line(dev) -> str:
    if dev.type != "cuda":
        return "cpu (no card: times are not device times)"
    res = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True, timeout=60)
    return res.stdout.strip().splitlines()[0]


def dev_ms(fn, dev, iters: int) -> float:
    import time

    import torch

    fn()
    if dev.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        return (time.perf_counter() - t0) * 1e3 / iters
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def kernel_names(fn, dev) -> list[str]:
    """Device kernels of one call of ``fn``, by torch.profiler (a trace at
    times holds no device time: up to three tries)."""
    if dev.type != "cuda":
        return []
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(3):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            fn()
            torch.cuda.synchronize()
        evs = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
        if evs:
            return [e.key for e in evs]
    return ["(no device time in three traces)"]


def randint8(shape, gen, dev):
    import torch

    return torch.randint(0, 128, shape, generator=gen, device=dev, dtype=torch.int8)


def probe_gemms(dev, gen, card, small: bool, iters: int) -> list[dict]:
    import torch

    rows_out = []
    for label, rows, m, N in GEMMS:
        if small:
            N = max(8, N // SMALL)
        K = m * D_IN
        A = randint8((rows, K), gen, dev)
        xkT = randint8((N, K), gen, dev)  # K-major: column n's K digits contiguous
        xk = xkT.t().contiguous()  # row-major (K, N)
        A40 = torch.zeros((rows, m, 40), dtype=torch.int8, device=dev)
        A40[:, :, :D_IN] = A.view(rows, m, D_IN)
        x40 = torch.zeros((N, m, 40), dtype=torch.int8, device=dev)
        x40[:, :, :D_IN] = xkT.view(N, m, D_IN)
        A40, x40 = A40.view(rows, m * 40), x40.view(N, m * 40)
        variants = {
            "n_major": lambda: torch._int_mm(A, xk),
            "k_major": lambda: torch._int_mm(A, xkT.t()),
            "k_major_d40": lambda: torch._int_mm(A40, x40.t()),
        }
        ref = variants["n_major"]()
        ops = 2.0 * rows * K * N
        for name, fn in variants.items():
            equal = bool(torch.equal(fn(), ref))
            ms = dev_ms(fn, dev, iters)
            row = {"shape": label, "rows": rows, "K": K if name != "k_major_d40" else m * 40, "N": N,
                   "layout": name, "ms": ms, "peak_pct": 100 * ops / (ms * 1e-3) / INT8_PEAK_OPS,
                   "equal": equal, "kernels": kernel_names(fn, dev)}
            rows_out.append(row)
            print(f"gemm {label} ({rows} x {row['K']}) @ ({row['K']} x {N}) {name}: {ms:.4f} ms, "
                  f"{row['peak_pct']:.2f} % of int8 peak (37-digit work), equal {equal}, "
                  f"kernels {row['kernels']} | {card}", flush=True)
        del A, xkT, xk, A40, x40, ref
    return rows_out


def probe_levels(dev, gen, card, small: bool, iters: int) -> list[dict]:
    import torch

    from tpu_ec_torch.ops import ntt_digit as nd

    out = []
    for label, n2, n2p, n1p, M in LEVELS:
        if small:
            n1p, M = max(1, n1p // SMALL), max(1, M // SMALL)
        n1 = n2p * n1p
        y = randint8((D_IN, n2, n1, M), gen, dev)
        nbytes = y.numel()

        def old():  # the transpose, then the row-major operand's permute
            x = y.transpose(1, 2).contiguous().view(D_IN, n2p, n1p * n2 * M)
            return x.permute(1, 0, 2).contiguous()

        def new():  # one permuted byte copy into (j1', k2, M, j2', d)
            return y.view(D_IN, n2, n2p, n1p, M).permute(3, 1, 4, 2, 0).contiguous()

        dst = torch.empty((n1p, n2, M, n2p, D_IN), dtype=torch.int8, device=dev)
        c = n2 // 16
        sizes, order = (n2, n2p, n1p, M), (2, 0, 3, 1)

        def words():  # the engine's copy of an unchunked level
            nd._to_kmajor(y.view(D_IN, n2, n2p, n1p, M), sizes, order, dst)

        def words_sliced():  # a chunked level: each slice of k2 from its own K2 output
            for a in range(0, n2, c):
                nd._to_kmajor(y[:, a : a + c], (c,) + sizes[1:], order, dst[:, a : a + c])

        def plain():
            return y.clone()

        want = old()
        ok = bool(torch.equal(new().view(-1, n2p * D_IN).t().reshape(n2p, D_IN, -1), want.view(n2p, D_IN, -1)))
        words_sliced()
        ok = ok and bool(torch.equal(dst.view(-1, n2p * D_IN).t().reshape(n2p, D_IN, -1), want.view(n2p, D_IN, -1)))
        del want
        row = {"boundary": label, "bytes": nbytes, "equal": ok}
        for name, fn in (("old_transpose_and_permute", old), ("byte_copy", new), ("words", words),
                         ("words_16_slices", words_sliced), ("plain_clone", plain)):
            row[name + "_ms"] = dev_ms(fn, dev, iters)
        out.append(row)
        print(f"copy {label} ({nbytes / 2**30:.3f} GiB): old {row['old_transpose_and_permute_ms']:.3f} ms, one "
              f"byte copy {row['byte_copy_ms']:.3f}, words {row['words_ms']:.3f}, words in 16 slices "
              f"{row['words_16_slices_ms']:.3f}, plain clone {row['plain_clone_ms']:.3f}; same operand {ok} "
              f"| {card}", flush=True)
        del y, dst
    return out


def probe_first(dev, gen, card, small: bool, iters: int) -> list[dict]:
    import torch

    from tpu_ec_torch.ops import ntt_digit as nd
    from tpu_ec_torch.ops.ntt_digit import split_digits_rows

    out = []
    for label, n2, n1 in FIRST:
        if small:
            n1 = max(8, n1 // SMALL)
        n = n2 * n1
        x = torch.randint(0, 1 << 16, (n, 16), generator=gen, device=dev, dtype=torch.int32)
        x[:, -1] &= 0x0FFF
        block = 1 << 22 if not small else 1 << 12

        def old():  # the split into planes in blocks of rows, then the row-major operand's permute
            planes = torch.empty((D_IN, n), dtype=torch.int8, device=dev)
            for s in range(0, n, block):
                planes[:, s : s + block] = split_digits_rows(x[s : s + block].T.contiguous(), D_IN)
            return planes.view(D_IN, n2, n1).permute(1, 0, 2).contiguous()

        def new():  # the engine's: blocks of j1 columns -> (j1, j2, d) rows
            xkT = torch.empty((n1, n2, D_IN), dtype=torch.int8, device=dev)
            nd._split_first(x.view(n2, n1, 1, 16).permute(3, 0, 1, 2), xkT.view(n1, 1, n2, D_IN), D_IN, block=block)
            return xkT

        ok = bool(torch.equal(new().view(n1, n2 * D_IN).t(), old().view(n2 * D_IN, n1)))
        row = {"first": label, "n": n, "equal": ok, "old_ms": dev_ms(old, dev, iters),
               "new_ms": dev_ms(new, dev, iters)}
        out.append(row)
        print(f"first level {label}: old split + permute {row['old_ms']:.3f} ms, new K-major split "
              f"{row['new_ms']:.3f} ms; same operand {ok} | {card}", flush=True)
        del x
    return out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--small", action="store_true", help="shapes cut for a rehearsal on the CPU")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--skip-gemm", action="store_true", help="time the copies only")
    ap.add_argument("--out", default=None, help="also write the JSON object here")
    args = ap.parse_args()

    import torch

    dev = torch.device(args.device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        print("leaf_gemm_probe: no CUDA device available", file=sys.stderr)
        return 1
    card = card_line(dev)
    print(f"card: {card} | torch {torch.__version__} cuda {torch.version.cuda}", flush=True)
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    res = {"card": card, "torch": torch.__version__,
           "gemm": [] if args.skip_gemm else probe_gemms(dev, gen, card, args.small, args.iters),
           "levels": probe_levels(dev, gen, card, args.small, args.iters),
           "first": probe_first(dev, gen, card, args.small, args.iters)}
    text = json.dumps(res)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
