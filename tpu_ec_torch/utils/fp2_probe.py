#!/usr/bin/env python3
"""Measure K3's Fq2 (G2) instances on the card: builds of variants, code
size, registers, times and latencies.  On no path; for choosing and checking
the Fq2 designs, and for comparing two checkouts on one card.

    PYTHONPATH=<checkout> python3 tpu_ec_torch/utils/fp2_probe.py [--variants V ...] [--tiles 4]

Imports ``tpu_ec_torch`` from the first checkout on ``PYTHONPATH`` and
compiles that checkout's ``csrc/``.  It prints, with the card's name and
power limit:

- per build variant of a G2 unit (``--variants``, below): its nvcc wall
  time, registers and spill bytes (``-Xptxas -v``) and SASS instructions
  (``cuobjdump -sass``) of each kernel; the same of the checkout's library's
  Fq2 kernels and G1 point kernel at 12 words;
- each point variant's ``add`` at the shape of the BLS12-381 G2 MSM's scan
  round 0 at 2^20 (the fused (16, 2^20, 144) block of its sorted rows, keep
  and out=, as ``ops/msm_scan.py`` runs it; bases are 2^16 points k G2, k
  random 64-bit, tiled 16 times), each output held bit-equal to the
  checkout's library's;
- each stage variant's time at stage 0 of a BN254 G2 2^11 and a BLS12-381
  G2 2^11 transform, each equal to the library's;
- one Fq product's latency on one thread (``kernels.point.mul_chain``), one
  level of N Fq2 products in series on one tile of the checkout's
  ``TileProducts2`` (N = 1 and 4, the tile sizes of ``--tiles``), and one
  Fq2 point op in series (a one-point chain over 2^256 - 1: 255 doublings
  and 255 adds, the library's chain entry), at 8 and 12 words.

A variant is NAME=UNIT:FLAGS, FLAGS nvcc arguments split on commas
(``-maxrregcount=168``, or ``-DNAME=V`` where the sources read NAME: the
knobs ``TEC_FP2_TILE``, ``TEC_FP2_POINT_BLOCKS`` and ``TEC_FP2_MUL_OUTLINE``
of commit ca61e19), or one of the named sets below; with no
``--variants`` it builds the point unit as it is and under
``-maxrregcount`` 168 and 128.  A flag "+NAME" patches a copy of the
sources (``PATCHES``: the tree of commit c5496f6).  Every number comes
from this run; a JSON line of all of them ends the output.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile
import time

SEED = 20240601

# a tile of T lanes runs `steps` levels of N Fq2 products in series,
# x_k = x_k y_k (TileProducts2::mul_many), and stores x canonical (every
# lane its part: the whole element, or its component)
LEVEL_SRC = r"""
#include "field_tile.cuh"
using tec::FieldConsts;
template <int NW, int T, int N>
__global__ void level_chain(const int32_t* a, const int32_t* b, int steps, int32_t* out,
                            const __grid_constant__ FieldConsts fc) {
  using F = tec::TileProducts2<NW, T>;
  const F f(fc);
  typename F::E x[N], y[N];
#pragma unroll
  for (int k = 0; k < N; ++k) {
    x[k] = f.load(a + 4 * NW * k);
    y[k] = f.load(b + 4 * NW * k);
  }
#pragma unroll 1
  for (int s = 0; s < steps; ++s) {
    typename F::E t[N];
    f.mul_many(t, x, y);
#pragma unroll
    for (int k = 0; k < N; ++k) x[k] = t[k];
  }
#pragma unroll
  for (int k = 0; k < N; ++k) f.store(out + 4 * NW * k, f.canon(x[k]));
}
template <int NW, int N>
int run(const void* a, const void* b, int steps, void* out, const FieldConsts& c, cudaStream_t s) {
  level_chain<NW, TILE, N><<<1, TILE, 0, s>>>((const int32_t*)a, (const int32_t*)b, steps, (int32_t*)out, c);
  return (int)cudaGetLastError();
}
extern "C" int probe_level(int nw, int n, const void* a, const void* b, int steps, void* out, const uint32_t* h,
                           void* stream) {
  const FieldConsts c = tec::field_consts_from_host(h);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8 && n == 1) return run<8, 1>(a, b, steps, out, c, s);
  if (nw == 8 && n == 4) return run<8, 4>(a, b, steps, out, c, s);
  if (nw == 12 && n == 1) return run<12, 1>(a, b, steps, out, c, s);
  if (nw == 12 && n == 4) return run<12, 4>(a, b, steps, out, c, s);
  return (int)cudaErrorInvalidValue;
}
"""

# source patches a variant may name ("+NAME"): (file, text, replacement
# inside the text after it) -- the Fq2 product out of line (one body of each
# Fq product, not 43), and the Fq2 point kernel's launch bounds at 3 or 4
# blocks of 128 (<= 168 or <= 128 registers)
NOINLINE_DEF = ("template <int NW>\n__device__ __noinline__ Fe<NW> mul_out(const Fe<NW>& a, const Fe<NW>& b, "
                "const FieldConsts& fc) {\n  return fe_mul_lazy<NW>(a, b, fc);\n}\n\n")
PATCHES = {
    "noinline": ("field2.cuh", "// Fq2 on the same functions, component by component.", "fe_mul_lazy<NW>",
                 "mul_out<NW>", NOINLINE_DEF),
    "lb3": ("point.cuh", "constexpr int kMinBlocks", "F::kExt == 1 ? 4 : 1", "F::kExt == 1 ? 4 : 3", ""),
    "lb4": ("point.cuh", "constexpr int kMinBlocks", "F::kExt == 1 ? 4 : 1", "F::kExt == 1 ? 4 : 4", ""),
}

NAMED = {
    "point": "g2_point.cu:",
    "point-rr168": "g2_point.cu:-maxrregcount=168",
    "point-rr128": "g2_point.cu:-maxrregcount=128",
    "point-lb3": "g2_point.cu:+lb3",
    "point-lb4": "g2_point.cu:+lb4",
    "point-noinline": "g2_point.cu:+noinline",
    "point-noinline-lb3": "g2_point.cu:+noinline,+lb3",
    "stage": "g2_ec_fft_stage.cu:",
}

UNIT_ENTRY = {"g2_point.cu": "tec_point_fp2", "g2_ec_fft_stage.cu": "tec_ec_fft_stage_fp2",
              "g2_scalar_mul.cu": "tec_point_scalar_mul_fp2", "g2_horner.cu": "tec_point_horner_fp2"}


def card_line() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]


def ptxas(report: str) -> dict:
    """{mangled kernel: (registers, spill store bytes)} from -Xptxas -v (a
    non-inlined callee's properties are its own, not its caller's)."""
    out, entry, props = {}, None, None
    for ln in report.splitlines():
        if (m := re.search(r"Compiling entry function '([^']+)'", ln)):
            entry = m.group(1)
            out[entry] = [None, None]
        elif (m := re.search(r"Function properties for (\S+)", ln)):
            props = m.group(1)
        elif (m := re.search(r"(\d+) bytes spill stores", ln)) and props in out:
            out[props][1] = int(m.group(1))
        elif (m := re.search(r"Used (\d+) registers", ln)) and entry in out and out[entry][0] is None:
            out[entry][0] = int(m.group(1))
    return {k: tuple(v) for k, v in out.items()}


def sass_sizes(so: str) -> dict:
    """{mangled kernel or function: SASS instructions} of a built library."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", so], capture_output=True, text=True, check=True, timeout=600)
    sizes, cur = {}, None
    for ln in res.stdout.splitlines():
        if (m := re.search(r"Function : (\S+)", ln)):
            cur = m.group(1)
            sizes[cur] = 0
        elif cur and re.search(r"/\*[0-9a-f]{4,}\*/\s+[@A-Z]", ln):
            sizes[cur] += 1
    return sizes


def label(mangled: str) -> str:
    """A short name of a K3 kernel's mangled symbol."""
    nw = re.findall(r"Li(\d+)E", mangled)
    for key, names in (("point_kernel", ("add", "add_mixed", "double")),
                       ("point2_kernel", ("add", "add_mixed", "double"))):
        if key in mangled:
            return f"{names[int(nw[-1])]}<{nw[0]}>"
    for key in ("ec_fft_stage_kernel", "scalar_mul_kernel", "horner_kernel", "level_chain", "double2_to",
                "double_to", "mul_part", "mul_out"):
        if key in mangled:
            return f"{key}<{','.join(nw)}>"
    return mangled[:60]


def build_variants(build, variants: list, tiles: list, workdir: str) -> dict:
    """Compile every variant (one nvcc each, all started together) and the
    level probe at each tile size.  Returns {name: (so path, unit, seconds,
    ptxas report)}."""
    nvcc = build._nvcc()
    jobs = {}
    for name, unit, flags in variants:
        src_dir = build.CSRC
        extra = [f for f in flags if f and not f.startswith("+")]
        patches = [f[1:] for f in flags if f.startswith("+")]
        if patches:
            src_dir = os.path.join(workdir, f"csrc_{name}")
            shutil.copytree(build.CSRC, src_dir)
        missing = []
        for pname in patches:
            fname, anchor, old, new, prefix = PATCHES[pname]
            path = os.path.join(src_dir, fname)
            with open(path) as f:
                head, sep, tail = f.read().partition(anchor)
            if not sep or old not in tail:
                missing.append(pname)
                continue
            with open(path, "w") as f:
                f.write(head + prefix + sep + tail.replace(old, new))
        if missing:
            print(f"variant {name}: patches {missing} find nothing to change here; skipped", flush=True)
            continue
        so = os.path.join(workdir, f"lib_{name}.so")
        cmd = [nvcc, *build.FLAGS, "-shared", *extra, "-o", so, os.path.join(src_dir, unit)]
        jobs[name] = (unit, so, cmd)
    for t in tiles:
        src = os.path.join(workdir, f"level_{t}.cu")
        with open(src, "w") as f:
            f.write(LEVEL_SRC)
        so = os.path.join(workdir, f"lib_level_{t}.so")
        jobs[f"level-T{t}"] = ("level", so, [nvcc, *build.FLAGS, "-shared", f"-DTILE={t}", f"-I{build.CSRC}",
                                            "-o", so, src])
    t0 = time.perf_counter()
    procs = {k: subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
             for k, (_, _, cmd) in jobs.items()}
    out = {}
    for k, p in procs.items():
        _, err = p.communicate()
        secs = time.perf_counter() - t0
        if p.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {k}:\n{err[-3000:]}")
        out[k] = (jobs[k][1], jobs[k][0], secs, err)
    return out


class _Lib:
    """The checkout's library with some entries taken from a variant's."""

    def __init__(self, main, variant, names):
        self._main, self._variant, self._names = main, variant, names

    def __getattr__(self, name):
        return getattr(self._variant if name in self._names else self._main, name)


def variant_lib(main, so: str, unit: str):
    lib = ctypes.CDLL(so)
    entry = UNIT_ENTRY[unit]
    ref = getattr(main, entry)
    fn = getattr(lib, entry)
    fn.argtypes, fn.restype = ref.argtypes, ref.restype
    return _Lib(main, lib, {entry})


def cuda_ms(fn, iters: int = 5) -> float:
    import torch

    fn()
    torch.cuda.synchronize()
    a, b = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(iters):
        fn()
    b.record()
    torch.cuda.synchronize()
    return a.elapsed_time(b) / iters


def coords(nc, arr, k: int, dev):
    import torch

    w = nc.w
    return tuple(torch.as_tensor(nc.coord_to_halflimbs(arr[:, i * w : (i + 1) * w]).astype("int64"))
                 .to(dev, torch.int32) for i in range(k))


def points(nc, rng, n: int):
    import numpy as np

    G = nc.affine_from_points([(nc.spec.gen_x, nc.spec.gen_y)])
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    jac = nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks)
    return jac, nc.to_affine(jac)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--variants", nargs="*", default=["point", "point-rr168", "point-rr128"],
                    help="NAME=UNIT:FLAGS or a named set (" + ", ".join(NAMED) + ")")
    ap.add_argument("--tiles", default="4", help="tile sizes of the level probe, comma-separated")
    ap.add_argument("--log-n", type=int, default=20, help="the scan round's rows 2^LOG_N (default 20)")
    args = ap.parse_args()

    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("fp2_probe: no CUDA device available", file=sys.stderr)
        return 1
    import tpu_ec_torch
    from tpu_ec_torch.curves.params import BLS12_381_G2, BN254_G2
    from tpu_ec_torch.fields.params import BLS12_381_FQ, BLS12_381_FR, BN254_FQ
    from tpu_ec_torch.kernels import build
    from tpu_ec_torch.kernels import point as kpoint
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.ec_fft import EcFftKernel
    from tpu_ec_torch.ops.msm import SCALAR_BITS, MultiexpKernel, make_digits
    from tpu_ec_torch.ops.msm_scan import _shifted_add, default_window_size_scan, scan_keep, sorted_rows

    card = card_line()
    dev = torch.device("cuda")
    res = {"package": tpu_ec_torch.__file__.rsplit("/", 2)[0], "card": card, "variants": {}}
    print(f"device: {card} | package {res['package']}", flush=True)
    variants = []
    for v in args.variants:
        name, spec = (v, NAMED[v]) if v in NAMED else v.split("=", 1)
        unit, flags = spec.split(":", 1)
        variants.append((name, unit, flags.split(",") if flags else []))
    tiles = [int(t) for t in args.tiles.split(",") if t]

    t0 = time.perf_counter()
    t_lib = build.build()
    main_lib = build.load()
    print(f"build: the checkout's library {t_lib:.1f} s (0 = built before)", flush=True)
    work = tempfile.mkdtemp(prefix="fp2_probe_", dir=os.path.dirname(build.library_path()))
    built = build_variants(build, variants, tiles, work)
    print(f"build: {len(built)} variants side by side, {time.perf_counter() - t0:.1f} s in all", flush=True)

    # the library's G1 point kernel at 12 words and every Fq2 kernel
    lib_sass = sass_sizes(build.library_path())
    for k, (regs, spill) in ptxas(build.ptxas_report()).items():
        g1 = "Ext1ILi12E" in k and "point_kernel" in k
        if g1 or any(t in k for t in ("Ext2", "TileProducts2", "point2_kernel")):
            key = ("G1 " if g1 else "Fq2 ") + label(k)
            res.setdefault("library", {})[key] = dict(regs=regs, spill=spill, sass=lib_sass.get(k))
            print(f"library {key}: {regs} regs, spill {spill} B, {lib_sass.get(k)} SASS instructions", flush=True)
    for name, (so, unit, secs, report) in built.items():
        regs = ptxas(report)
        sizes = sass_sizes(so)
        row = {"unit": unit, "nvcc_s": round(secs, 1), "kernels": {}}
        for k, (r, s) in regs.items():
            row["kernels"][label(k)] = dict(regs=r, spill=s, sass=sizes.get(k))
        others = {label(k): v for k, v in sizes.items() if k not in regs}
        if others:
            row["functions"] = others
        res["variants"][name] = row
        print(f"variant {name} ({unit}): nvcc {secs:.1f} s; " + "; ".join(
            f"{k} {v['regs']} regs, spill {v['spill']} B, {v['sass']} SASS" for k, v in row["kernels"].items())
            + (f"; out-of-line {others}" if others else ""), flush=True)

    rng = np.random.default_rng(SEED + 7)
    # one Fq product, one level of N Fq2 products, one Fq2 point op: latencies
    res["latency_us"] = {}
    for fq, curve in ((BN254_FQ, BN254_G2), (BLS12_381_FQ, BLS12_381_G2)):
        nw = fq.n_limbs // 2
        L = fq.n_limbs
        a = torch.as_tensor(rng.integers(0, 1 << 16, (8, 2 * L))).to(dev, torch.int32)
        a[:, L - 1] = a[:, 2 * L - 1] = 0  # below p
        b = a.flip(0).contiguous()
        steps = 1 << 12
        lat = {"fq_product": cuda_ms(lambda: kpoint.mul_chain(fq, a[0, :L].contiguous(), b[0, :L].contiguous(),
                                                                steps)) / steps * 1e3}
        for t in tiles:
            lib = ctypes.CDLL(built[f"level-T{t}"][0])
            lib.probe_level.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [ctypes.c_int] + \
                [ctypes.c_void_p] * 3
            for n_prod in (1, 4):
                out = torch.empty((n_prod, 2 * L), dtype=torch.int32, device=dev)
                run = lambda s: lib.probe_level(nw, n_prod, a.data_ptr(), b.data_ptr(), s, out.data_ptr(),
                                                build.field_consts(fq), build.stream())
                run(16)
                F = kpoint._PlainField2(fq, dev)
                x, y = a[:n_prod].to(torch.int64), b[:n_prod].to(torch.int64)
                for _ in range(16):
                    x = torch.stack(F.mul_many(*((x[k], y[k]) for k in range(n_prod))))
                if not torch.equal(out.to(torch.int64), x):
                    raise SystemExit(f"level probe T={t} N={n_prod} at {nw} words disagrees with its plain version")
                lat[f"fq2_level_N{n_prod}_T{t}"] = cuda_ms(lambda: run(steps)) / steps * 1e3
        jac, _ = points(native_curve(curve), rng, 1)
        P = coords(native_curve(curve), jac, 3, dev)
        ones = torch.full((1, 16), 0xFFFF, dtype=torch.int32, device=dev)
        lat["fq2_point_op"] = cuda_ms(lambda: kpoint.point_scalar_mul(fq, P, ones, ext=2)) / 510 * 1e3
        res["latency_us"][nw] = lat
        print(f"latency at {nw} words (us): " + ", ".join(f"{k} {v:.4f}" for k, v in lat.items()) + f" | {card}",
              flush=True)

    point_vars = [k for k, v in built.items() if v[1] == "g2_point.cu"]
    if point_vars:
        # the BLS12-381 G2 MSM's scan round 0 at 2^log_n
        n = 1 << args.log_n
        nc = native_curve(BLS12_381_G2)
        _, aff = points(nc, rng, min(n, 1 << 16))
        aff = np.tile(aff, (n // aff.shape[0], 1))
        msm = MultiexpKernel(BLS12_381_G2)
        ops = msm.ops
        bases = msm.upload_bases(coords(nc, aff, 2, dev))
        s = rng.integers(0, 1 << 16, (n, 16), dtype=np.int64)
        s[:, -1] &= 0x0FFF
        scal = torch.as_tensor(s).to(dev, torch.int32)
        w = default_window_size_scan(n)
        sc = torch.cat([scal, scal.new_zeros((n, 1))], dim=1)
        dig = make_digits(sc, w, -(-SCALAR_BITS // w), True).T.unsqueeze(0)
        key, data = sorted_rows(ops, tuple(c.unsqueeze(0) for c in bases), dig)
        keep = scan_keep(key, 1)
        del key, dig, bases
        L2 = ops.width
        run = lambda: _shifted_add(ops, data, 1, keep, L2)
        want = run()
        res["round0"] = {"shape": list(data.shape), "library_ms": cuda_ms(run)}
        print(f"scan round 0 {tuple(data.shape)}: the checkout's library {res['round0']['library_ms']:.4f} ms "
              f"| {card}", flush=True)
        load = kpoint.load
        try:
            for name in point_vars:
                so, unit = built[name][:2]
                kpoint.load = lambda lib=variant_lib(main_lib, so, unit): lib
                got = run()
                if not torch.equal(got, want):
                    raise SystemExit(f"variant {name}: the add disagrees with the library's")
                ms = cuda_ms(run)
                res["variants"][name]["round0_ms"] = ms
                print(f"variant {name}: scan round 0 {ms:.4f} ms, == the library's | {card}", flush=True)
                del got
        finally:
            kpoint.load = load
        del data, keep, want

    stage_vars = [k for k, v in built.items() if v[1] == "g2_ec_fft_stage.cu"]
    if stage_vars:
        for curve, fq in ((BN254_G2, BN254_FQ), (BLS12_381_G2, BLS12_381_FQ)):
            nc = native_curve(curve)
            jac, _ = points(nc, rng, 1 << 11)
            P = coords(nc, jac, 3, dev)
            tw = EcFftKernel(curve)._domain_tensors(11, False)[0]
            run = lambda: kpoint.ec_fft_stage(fq, P, tw, 0, ext=2)
            want = run()
            lib_ms = cuda_ms(run)
            res.setdefault("stage0_library_ms", {})[curve.name] = lib_ms
            print(f"stage 0 {curve.name} 2^11: the checkout's library {lib_ms:.4f} ms | {card}", flush=True)
            load = kpoint.load
            try:
                for name in stage_vars:
                    so, unit = built[name][:2]
                    kpoint.load = lambda lib=variant_lib(main_lib, so, unit): lib
                    if not all(torch.equal(g, h) for g, h in zip(run(), want)):
                        raise SystemExit(f"variant {name}: stage 0 of {curve.name} disagrees with the library's")
                    ms = cuda_ms(run)
                    res["variants"][name].setdefault("stage0_ms", {})[curve.name] = ms
                    print(f"variant {name}: stage 0 {curve.name} {ms:.4f} ms, == the library's | {card}",
                          flush=True)
            finally:
                kpoint.load = load

    shutil.rmtree(work, ignore_errors=True)
    print(json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
