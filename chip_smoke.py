#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ec_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # BLS12-381 G1 commit at n = 2^20
    python3 chip_smoke.py --log-n 14 # a smaller commit, for a quick check

Phases, each failing the run on any error:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels (csrc/, nvcc for sm_90a) and the native C++
   referee (g++), with the seconds each took and the kernels' register and
   spill counts from ``-Xptxas -v``;
3. kernels: K1 (Montgomery product), K2 (digit-NTT twiddle) and K3 (point
   add / add_mixed / double) against their plain PyTorch versions on the
   same card tensors, bit-exact, with both times;
4. the slice: ``CommitPipeline(BLS12_381_G1, device="cuda").commit`` on
   random Montgomery coefficients and 2^n points k*G, the evaluations
   checked bit-exact against the native C++ NTT and the commitment against
   the native C++ Pippenger; launch counts of the main path's run (each
   kernel must have launched), ms per commit, per-stage split, peak memory;
5. a JSON line of the kernels, the card line again, and the result line.

The script needs the repository (it imports tpu_ec_torch and builds
native/src/ec_native.cpp); it imports nothing of JAX.  Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import re
import subprocess
import sys
import time

SEED = 20240601
CHUNK = 1 << 18  # rows per call of a plain version (bounds its temporaries)


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 5) -> float:
    """Device milliseconds per call (CUDA events, after one warm-up call)."""
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


def chunked(fn, *arrays, axis: int = 0):
    """Run a plain version over row chunks of its batched inputs."""
    import torch

    n = arrays[0].shape[axis]
    outs = [fn(*(a.narrow(axis, lo, min(CHUNK, n - lo)) for a in arrays)) for lo in range(0, n, CHUNK)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts, dim=axis) for parts in zip(*outs))
    return torch.cat(outs, dim=axis)


def mismatch(a, b) -> tuple[int, int]:
    """(rows that differ, max |a - b|) of two row-major integer results (or
    tuples of them)."""
    import torch

    if isinstance(a, tuple):
        rows = [mismatch(x, y) for x, y in zip(a, b)]
        return max(r[0] for r in rows), max(r[1] for r in rows)
    d = (a.to(torch.int64) - b.to(torch.int64)).abs().reshape(a.shape[0], -1)
    return int((d != 0).any(dim=1).sum()), int(d.max())


def random_field(rng, spec, n: int):
    """n random canonical elements (< p) as (n, L) int64 half-limbs; rows 0-2
    are the edge values 0, 1 and p - 1."""
    import numpy as np

    L = spec.n_limbs
    a = rng.integers(0, 1 << 16, (n, L), dtype=np.int64)
    a[:, -1] = rng.integers(0, int(spec.p_limbs[-1]), n)  # below p's top limb
    a[0:2] = 0
    a[1, 0] = 1
    pm1 = spec.modulus - 1
    a[2] = [(pm1 >> (16 * i)) & 0xFFFF for i in range(L)]
    return a


def random_points(nc, rng, n: int):
    """n points k*G with random 64-bit k (native scalar mul): the Jacobian
    (n, 3w) and affine (n, 2w) u64 arrays of the native layout."""
    import numpy as np

    from tpu_ec_torch.curves.params import BLS12_381_G1

    G = nc.affine_from_points([(BLS12_381_G1.gen_x, BLS12_381_G1.gen_y)])
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    jac = nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks)
    return jac, nc.to_affine(jac)


def coords_from_u64(nc, arr, k: int, device):
    """k coordinates of a native (n, k*w) u64 array -> port tensors."""
    import torch

    w = nc.w
    return tuple(
        torch.as_tensor(nc.fq.to_halflimbs(arr[:, i * w : (i + 1) * w]).astype("int64"))
        .to(device=device, dtype=torch.int32)
        for i in range(k)
    )


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel: registers and spill bytes from ``-Xptxas -v``."""
    lines, name = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln)
        if m:
            name = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads", ln)
        if m and name:
            spill = f"stack {m.group(1)} B, spill st {m.group(2)} B ld {m.group(3)} B"
            lines.append([name, spill])
            continue
        m = re.search(r"Used (\d+) registers", ln)
        if m and lines and lines[-1][0] == name and len(lines[-1]) == 2:
            lines[-1].append(f"{m.group(1)} regs")
    short = []
    for entry in lines:
        nm = entry[0]
        for key, label in (("mont_mul_kernel", "K1 mont_mul"), ("inter_kernel", "K2 inter"),
                           ("point_kernel", "K3 point")):
            if key in nm:
                tmpl = re.findall(r"ILi(\d+)E", nm)
                nm = f"{label}<{','.join(tmpl)}>" if tmpl else label
        short.append(f"{nm}: {', '.join(entry[1:][::-1])}")
    return short


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20, help="commit size 2^log_n (default 20)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    import numpy as np

    from tpu_ec_torch import kernels
    from tpu_ec_torch.curves.params import BLS12_381_G1
    from tpu_ec_torch.fields.params import BLS12_381_FQ, BLS12_381_FR
    from tpu_ec_torch.kernels import build
    from tpu_ec_torch.kernels.inter import inter_twiddle, inter_twiddle_plain
    from tpu_ec_torch.kernels.mont import mont_mul, mont_mul_plain
    from tpu_ec_torch.kernels.point import point_op, point_op_plain
    from tpu_ec_torch.native import native_curve, native_field
    from tpu_ec_torch.ops.ntt_digit import digit_consts, get_digit_domain, leaf_log
    from tpu_ec_torch.ops.pipeline import CommitPipeline
    from tpu_ec_torch.utils.measure import timeit

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n = 1 << args.log_n
    timings: dict[str, tuple[float, float]] = {}
    errors: dict[str, int] = {}

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)

    # 2. build
    t_build = build.build()
    build.load()
    t0 = time.perf_counter()
    nc = native_curve(BLS12_381_G1)
    nfr = native_field(BLS12_381_FR)
    t_native = time.perf_counter() - t0
    print(f"build: kernels {t_build:.1f} s (0 = already built), native {t_native:.1f} s", flush=True)
    for ln in ptxas_summary(build.ptxas_report()):
        print(f"ptxas: {ln}", flush=True)

    # 3. kernels against their plain versions, bit-exact
    for spec in (BLS12_381_FR, BLS12_381_FQ):
        a = torch.as_tensor(random_field(rng, spec, n)).to(dev, torch.int32)
        b = torch.as_tensor(random_field(rng, spec, n)[::-1].copy()).to(dev, torch.int32)
        got = mont_mul(spec, a, b)
        want = chunked(lambda x, y: mont_mul_plain(spec, x, y), a, b)
        bad, err = mismatch(got, want)
        errors["mont_mul"] = max(errors.get("mont_mul", 0), err)
        k_ms = cuda_ms(lambda: mont_mul(spec, a, b))
        p_ms = cuda_ms(lambda: chunked(lambda x, y: mont_mul_plain(spec, x, y), a, b), iters=1)
        print(f"K1 mont_mul {spec.name} n=2^{args.log_n}: mismatches {bad}, "
              f"kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
        if bad:
            raise SystemExit(f"K1 disagrees with its plain version on {bad} rows")
    # the main path's K1 shape: from_mont of the 2^n evaluations
    unit = torch.zeros(16, dtype=torch.int32, device=dev)
    unit[0] = 1
    evals_like = torch.as_tensor(random_field(rng, BLS12_381_FR, n)).to(dev, torch.int32)
    bad, err = mismatch(
        mont_mul(BLS12_381_FR, evals_like, unit),
        chunked(lambda x: mont_mul_plain(BLS12_381_FR, x, unit), evals_like),
    )
    timings["mont_mul"] = (
        cuda_ms(lambda: mont_mul(BLS12_381_FR, evals_like, unit)),
        cuda_ms(lambda: chunked(lambda x: mont_mul_plain(BLS12_381_FR, x, unit), evals_like), iters=1),
    )
    print(f"K1 from_mont shape (2^{args.log_n}, 16) x (16,): mismatches {bad}, "
          f"kernel {timings['mont_mul'][0]:.3f} ms, plain {timings['mont_mul'][1]:.3f} ms", flush=True)
    if bad:
        raise SystemExit("K1 disagrees with its plain version (from_mont shape)")

    dom = get_digit_domain(BLS12_381_FR, args.log_n, False, leaf_log(args.log_n))
    consts = digit_consts(dom, dev)
    bound = (1 << max(dom.plan)) * dom.d_in * 127 * 127
    shapes = []
    log_rest, M = args.log_n, 1
    for lf in dom.plan[:-1]:
        n1_log = log_rest - lf
        T = consts["inter"][(log_rest, n1_log)]
        n2, n1 = T.shape[1], T.shape[2]
        tfull = T[:, :, :, None].expand(16, n2, n1, M).reshape(16, n).contiguous()
        shapes.append((f"level {len(shapes)} (37, 2^{args.log_n}) x T (16, 2^{args.log_n}) -> int8",
                       tfull, False, False))
        log_rest, M = n1_log, M * n2
    shapes.append((f"final (37, 2^{args.log_n}) x const T -> canonical (16, 2^{args.log_n})",
                   consts["final_c"], True, True))
    for i, (label, t16, canonical, const_t) in enumerate(shapes):
        cols = torch.as_tensor(rng.integers(0, bound, (37, n), dtype=np.int64)).to(dev, torch.int32)
        kw = dict(canonical=canonical, const_t=const_t)
        got = inter_twiddle(BLS12_381_FR, cols, t16, **kw)
        if const_t:
            want = chunked(lambda c: inter_twiddle_plain(BLS12_381_FR, c, t16, **kw), cols, axis=1)
        else:
            want = chunked(lambda c, t: inter_twiddle_plain(BLS12_381_FR, c, t, **kw),
                           cols, t16, axis=1)
        bad, err = mismatch(got.T, want.T)
        errors["inter_twiddle"] = max(errors.get("inter_twiddle", 0), err)
        k_ms = cuda_ms(lambda: inter_twiddle(BLS12_381_FR, cols, t16, **kw))
        if const_t:
            p_ms = cuda_ms(lambda: chunked(
                lambda c: inter_twiddle_plain(BLS12_381_FR, c, t16, **kw), cols, axis=1), iters=1)
        else:
            p_ms = cuda_ms(lambda: chunked(
                lambda c, t: inter_twiddle_plain(BLS12_381_FR, c, t, **kw), cols, t16, axis=1),
                iters=1)
        if i == 0:
            timings["inter_twiddle"] = (k_ms, p_ms)
        print(f"K2 inter {label}: mismatches {bad}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms",
              flush=True)
        if bad:
            raise SystemExit(f"K2 disagrees with its plain version on {bad} columns")

    npts = min(n, 1 << 16)
    jac, aff = random_points(nc, rng, 2 * npts)
    P = coords_from_u64(nc, jac[:npts], 3, dev)
    Q = [c.clone() for c in coords_from_u64(nc, jac[npts:], 3, dev)]
    A = [c.clone() for c in coords_from_u64(nc, aff[npts:], 2, dev)]
    PA = coords_from_u64(nc, aff[:npts], 2, dev)
    p_fq = torch.as_tensor(np.asarray(BLS12_381_FQ.p_limbs, np.int64), device=dev)
    P = [c.clone() for c in P]
    for c in P:
        c[0] = 0  # row 0: P = identity
    for c in Q:
        c[1] = 0  # row 1: Q = identity
    A[0][1] = 0
    A[1][1] = 0  # row 1: A = identity
    for k in range(3):
        Q[k][2] = P[k][2]  # row 2: Q == P
    for k in range(2):
        A[k][2] = PA[k][2]  # row 2: A == P
    Q[0][3], Q[2][3] = P[0][3], P[2][3]  # row 3: Q == -P
    A[0][3] = PA[0][3]
    from tpu_ec_torch.fields.limbs import sub_borrow

    Q[1][3] = sub_borrow(p_fq, P[1][3].to(torch.int64))[0].to(torch.int32)
    A[1][3] = sub_borrow(p_fq, PA[1][3].to(torch.int64))[0].to(torch.int32)
    spec_q = BLS12_381_FQ
    for op, ins in (("add", [*P, *Q]), ("add_mixed", [*P, *A]), ("double", [*P])):
        got = point_op(spec_q, op, ins)
        want = chunked(lambda *c: point_op_plain(spec_q, op, list(c)), *ins)
        bad, err = mismatch(got, want)
        errors["point"] = max(errors.get("point", 0), err)
        k_ms = cuda_ms(lambda: point_op(spec_q, op, ins))
        p_ms = cuda_ms(lambda: point_op_plain(spec_q, op, ins), iters=1)
        if op == "add_mixed":
            timings["point"] = (k_ms, p_ms)
        print(f"K3 {op} n={npts}: mismatches {bad}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms",
              flush=True)
        if bad:
            raise SystemExit(f"K3 {op} disagrees with its plain version on {bad} rows")

    # 4. the slice: CommitPipeline.commit at n = 2^log_n
    t0 = time.perf_counter()
    coeffs_np = random_field(rng, BLS12_381_FR, n)
    _, bases_aff = random_points(nc, rng, n)
    print(f"inputs: {n} coefficients, {n} points k*G in {time.perf_counter() - t0:.1f} s",
          flush=True)
    pipe = CommitPipeline(BLS12_381_G1, device="cuda")
    coeffs = torch.as_tensor(coeffs_np).to(dev, torch.int32)
    bases = pipe.msm.upload_bases(coords_from_u64(nc, bases_aff, 2, dev))

    kernels.reset_launch_counters()
    t0 = time.perf_counter()
    evals, commitment = pipe.commit(coeffs, bases)
    torch.cuda.synchronize()
    t_first = time.perf_counter() - t0
    launches = kernels.launch_counters()
    print(f"main path launches: {launches} (first commit {t_first:.2f} s, tables included)",
          flush=True)
    missing = [k for k, v in launches.items() if v == 0]
    if missing:
        raise SystemExit(f"the main path launched no {missing}")

    t0 = time.perf_counter()
    want_evals = nfr.ntt(nfr.from_halflimbs(coeffs_np.astype(np.uint64)))
    got_evals = nfr.from_halflimbs(evals.cpu().numpy().astype(np.uint64))
    bad_evals = int((got_evals != want_evals).any(axis=1).sum())
    if evals.shape != (n, 16) or bad_evals:
        raise SystemExit(f"evaluations disagree with the native NTT on {bad_evals} rows")
    cx, cy = pipe.ops.to_affine(commitment)
    got_c = np.concatenate([nc.fq.from_halflimbs(c.cpu().numpy().astype(np.uint64)) for c in (cx, cy)], axis=1)
    want_c = nc.to_affine(nc.msm(bases_aff, nfr.from_mont(want_evals))[None, :])
    if not np.array_equal(got_c, want_c):
        raise SystemExit("commitment disagrees with the native Pippenger MSM")
    print(f"slice check: evaluations bit-exact vs native NTT ({n} rows), commitment == native "
          f"Pippenger ({time.perf_counter() - t0:.1f} s of host referee)", flush=True)

    torch.cuda.reset_peak_memory_stats()
    commit_ms = [0.0] * 3
    for i in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = pipe.commit(coeffs, bases)
        torch.cuda.synchronize()
        commit_ms[i] = (time.perf_counter() - t0) * 1e3
    peak = torch.cuda.max_memory_allocated()
    scalars = pipe.fr.from_mont(evals)
    stage = {
        name: timeit(fn, iters=3) * 1e3
        for name, fn in (("ntt", lambda: pipe.fft.radix_fft(coeffs)),
                         ("from_mont", lambda: pipe.fr.from_mont(evals)),
                         ("msm", lambda: pipe.msm.multiexp(bases, scalars)))
    }
    del out
    print(f"commit 2^{args.log_n}: {sum(commit_ms) / 3:.1f} ms mean of 3 ({', '.join(f'{t:.1f}' for t in commit_ms)}); "
          f"ntt {stage['ntt']:.2f} ms, from_mont {stage['from_mont']:.3f} ms, msm {stage['msm']:.1f} ms; "
          f"peak {peak / 2**30:.2f} GiB | {card}", flush=True)

    # 5. summary lines
    info = {
        "mont_mul": ("csrc/mont.cu", "tpu_ec/ops/pallas/mont.py:337"),
        "inter_twiddle": ("csrc/inter.cu", "tpu_ec/ops/ntt_digit.py:381"),
        "point": ("csrc/point.cu", "tpu_ec/ops/pallas/point.py:244"),
    }
    print(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": f"tpu_ec_torch/{src}", "replaces": rep,
         "launches": launches[name], "max_abs_err": errors[name],
         "ms": round(timings[name][0], 4), "plain_ms": round(timings[name][1], 4)}
        for name, (src, rep) in info.items()
    ]}), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
