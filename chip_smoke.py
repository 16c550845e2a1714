#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port (tpu_ec_torch) once on one NVIDIA GPU.

    python3 chip_smoke.py            # BLS12-381 G1 at n = 2^20 (AMT batch: 2^10 x 2^10 and 2^10 x 2^12), G2 at 2^20
    python3 chip_smoke.py --log-n 14 # smaller inputs, for a quick check (AMT chunks of 2^7; phase 4h keeps its sizes)

Phases, each failing the run on any error:

1. device: the card's name and power limit (nvidia-smi);
2. build: the CUDA kernels (csrc/, one nvcc per source for sm_90a, in
   parallel) and the native C++ referee (g++), with the seconds each took,
   the kernels' register and spill counts from ``-Xptxas -v``, the
   instruction mix of one 12-word Montgomery product (K1's kernel, from
   ``cuobjdump -sass``) and one product's latency on one thread at 8 and 12
   words (a dependent chain of 2^14 products, held against its plain
   version on 64): the unit of the chains' serial bounds;
3. kernels: every kernel against its plain PyTorch version on the same card
   tensors, bit-exact, with both times and the bound of its work: K1
   (Montgomery product), K2 (digit-NTT twiddle: the 2^n plan's levels, the
   table's rows read at column // M, the final pass, and the int8-digit
   entry into canonical rows), K3 (point add / add_mixed
   / double on 2^16 rows with identity, P == Q and P == -Q rows, the
   keep / out= entry, and K3's Horner entry at the commit's 19 windows of
   w = 14, bounded by its product levels in series), K5 (Pease stages at
   the shape of a 2^9 NTT batch: one stage, then all nine with the bit
   reversal, beside nine one-stage launches and a gather), K4 (leaf NTT
   at the leaf shapes of the 2^n fused plan, and with its level epilogue
   at the plan's level shapes, beside the leaf + K1 + transpose it
   replaces), K7 (affine denom
   and apply) and K6 (co-Z apply), the last three on 2^16 pairs of valid
   G1 points with identity, P == Q and P == -Q rows (K6 and K7's denom
   half are held and timed again at the co-Z path's shape in phase 4c), K7
   apply also on 2^n random rows, timed by device time (a CUDA graph);
4. the main path: ``CommitPipeline(BLS12_381_G1).commit`` on random
   Montgomery coefficients and 2^n points k*G, the evaluations checked
   bit-exact against the native C++ NTT and the commitment against the
   native C++ Pippenger; ms per commit, per-stage split, peak memory;
   then K3 against its plain version, timed and bounded, on the pair
   engine's own round-0 operands (affine pairs, add_mixed, (W, n/2)) and
   round-1 operands (Jacobian pairs, add, (W, n/4)), with the keep mask
   and fused out= rows as the path calls it;
4b. the fused NTT: ``FftKernel`` with config ``ntt_impl="fused"`` at 2^n on
   phase 4's coefficients (leaf 5 and leaf 8), equal to phase 4's
   evaluations, and its inverse giving the coefficients back; the forward
   transform must launch K4 once per level (the level epilogue on all but
   the last) and K1 never; then ``radix_fft_many`` on (2^11, 2^9, 16), K5's
   path, forward and inverse, one K5 launch each, against the native NTT on
   a sample of rows;
4c. the co-Z MSM: ``multiexp(..., method="coz")`` at 2^n on phase 4's bases
   and scalars, equal to phase 4's commitment; ms per MSM beside the pair
   engine's, peak memory; then K7 (denom) and K6 against their plain
   versions on the operands of the MSM's first round, (W, s, L) column
   slices of its fused rows, with their times and bounds;
4d. ``affine_add_batch`` (K7's apply half) on the phase-3 pairs, against
   the Jacobian mixed add; then the device time of each hand kernel over
   one commit, one co-Z MSM, one fused NTT, one ``radix_fft_many`` and
   one ``affine_add_batch`` (torch.profiler); a profile that fails, or
   holds no device time in three traces, fails the run, and so does any
   device op of the fused NTT or ``radix_fft_many`` other than K4 and K5;
4e. the AMT batch, ``multiple_multiexp`` on BLS12-381 G1: shape A, 2^10-point
   chunks x 2^(n-10) (phase 4's points, fresh Fr scalars), every chunk
   against the native C++ Pippenger, ms per batch, points/s, the slab,
   peak memory, and the K3 launches held against the count the rounds
   predict; shape B, four times the chunks (the points tiled four times),
   64 sampled chunks against native; the scan engine's batch (2^6 chunks)
   and one 2^16 scan MSM against the pair engine's; K3's batched Horner
   against its plain version on shape A's own window sums, bounded by its
   longest chain's product levels in series; a torch.profiler split of one
   shape-A batch;
4f. the EC-group FFT (``EcFftKernel``) on BN254 G1 at 2^4 .. 2^11 and on
   BLS12-381 G1 at 2^11, every output against the native C++ EC-FFT (affine),
   ms (mean of 3) and points/s; the 2^11 inverse against its input; a batch
   of 16 x 2^11 (``radix_ec_fft_many``) against 16 single calls; K3's chain
   entry at the path's launch (the BN254 2^11 inverse's scaling by n^-1,
   stride 0; also 1024 BLS12-381 points, random scalars) and EC-FFT stage
   entry (stages 0, log2(32 / T) - 1, log2(32 / T) and 10 of the BN254 2^11
   transform, T its tile of lanes, and stage 0 of the BLS12-381 one)
   against their plain versions, with both bounds (the operations, and one
   chain's serial latency from a one-point chain), the tile sizes, one
   point op's latency and both transforms' stage times; the launches of a
   transform (one stage entry a stage, one chain for the inverse's
   scaling); a
   torch.profiler split of the BLS12-381 2^11 transform, traced in a fresh
   process (``--profile-ec-fft``), which must hold every stage launch;
   ``commit_coefficient_basis`` and ``commit_sparse`` (a seeded
   half-density ``DensityTracker``, skip 0) at 2^n on phase 4's data, each
   against the native Pippenger over the same terms, with ms;
4g. G2, on K3's Fq2 instances (first their registers, spill bytes and SASS
   instructions from the build's ptxas report and ``cuobjdump``, their
   units' nvcc seconds, and the chains' tile of lanes):
   ``MultiexpKernel(BLS12_381_G2).multiexp``
   with "auto" (the scan engine, as in tpu_ec) at 2^n on points k_i G2 (random
   64-bit k_i, native scalar mul), its commitment against (sum k_i s_i) G2
   from one native scalar multiplication, its Fq2 K3 launches against the
   count the scan rounds predict and no G1 launch; ms (mean of 3),
   points/s, the window, chunks, peak memory; both curves at 2^16 against
   the native Pippenger; ``multiple_multiexp`` 2^6 x 2^10, every chunk
   against native; ``PointOps.scalar_mul`` on 1024 points against native;
   ``EcFftKernel`` on BN254 and BLS12-381 G2 at 2^11, forward against the
   native EC-FFT and the inverse against its input; a 2^16 G2
   ``CommitPipeline.commit`` against the native NTT and Pippenger; each
   Fq2 instance against its plain version with times and bounds (the add
   at the main path's shape, round 0 of its segmented scan: the fused
   (W, 2^n, 144) block of its own sorted rows (W = 16 at 2^20) with keep
   and out=; the point ops on 2^16 rows with identity, P == Q and P == -Q
   rows, and the keep / out= entry; the Horner at the main path's own
   window sums; the chain at 1024 points; the stage at stage 0 of the
   BN254 2^11 transform), and one Fq2 point op's latency in series at 8
   and 12 words (a one-point chain over 2^256 - 1);
4h. the digit NTT at 2^22 .. 2^26: ``FftKernel(BLS12_381_FR).radix_fft`` at
   2^22, 2^24 and 2^26 on the default routes (its own seed), every forward
   output against the native C++ NTT on all rows and the inverse against
   the input; the first call's seconds (tables included), ms mean of 3 of
   both directions, peak memory, each level's table route and whether the
   transform runs chunked, and the K1, K2 and K2-int8 launches of a call
   against the counts the plan predicts (``digit_launches``); at 2^26 the
   route the thresholds did not pick, equal bit for bit, with its ms and
   peak; BN254 Fr at 2^22 with the chunked route forced, against native;
   ``digit_ntt_planes_batch`` at (2^13, 2^11), 16 sampled columns against
   native and the inverse batch against the input; K2's int8 entry (its
   own kernel: a tile of columns a block, staged through shared memory)
   against its plain version at the final pass's shape, (37, 2^20) and
   (37, 2^26) digits into canonical rows, with its bound, ms / bound, the
   plain version's time and its registers and spills, and at a ragged n
   into planes and rows; K2's int32 level-0 row again;
4i. the bucket lattice (``ops/msm.py msm_lattice``) on BLS12-381: first
   K3's lattice entry (one tile a (group, window) lane: its buckets and
   running sum in one launch) against its plain version, bit for bit, on
   small lattices (BN254 and BLS12-381 G1 at 2^10, w = 4, G = 16; BLS12-381
   G2 at 2^8, w = 2, G = 8; unsigned and signed; an identity base, a zero
   scalar, a point and scalar on two steps in a row); then the unsigned
   ``multiexp(signed=False)`` ("auto" = the lattice) and the signed
   ``method="lattice"`` on G1 at 2^16 (phase 4's first points), with
   ``multiexp_1bit`` on the same, and an unsigned G2 MSM at 2^12, each
   against the native Pippenger, with ms (mean of 3), the window, groups
   and steps, K3 launches against ``lattice_steps`` (one lattice entry,
   log2 G adds, one Horner) and peak memory; for the two unsigned "auto"
   cases the lattice entry on the path's own operands against its plain
   version, with its time and bound (the busiest lane's product levels in
   series at one product's latency, its products at the IMAD rate, its
   bytes); for the unsigned G1 MSM its device time by kernel
   (torch.profiler); the window the card's table
   (``ops/tuned_windows.json``) gives the commit, beside phase 4's commit
   ms (phases 4, 4c, 4e and 4g take their windows as the engines do: the
   table, else the model);
4j. the multi-device layer (``tpu_ec_torch.parallel``) in an NCCL process
   group of world size 1, started from a FileStore (NCCL takes one rank a
   card, so the exchanges are degenerate here; d >= 2 runs in the CPU
   tests), after a group started with no backend named, whose probed mesh
   must be on the card too: ``dryrun_multichip(1)`` in a spawned rank; ``DistFftKernel`` at
   2^26 (n1 = n2 = 2^13, digit local stages, its own seed) against the
   single-card transform on every row, the inverse against the input,
   first-call seconds, ms of both directions, peak, the K1 / K2 / K2-int8
   launches of a call against ``digit_launches`` of both stages and a
   profile of one call; ``DistMultiexpKernel`` on phase 4's bases and
   scalars with ``dist_msm_accum`` "pair" and "scan", each against the
   commitment (affine), with ms, window, K3 launches and peak;
   ``DistEcFftKernel`` on phase 4f's 16 x 2^11 batch against its output;
   ``multiexp(method="sorted")`` on phase 4's data against the commitment,
   its K3 launches against ``sorted_steps``, ms beside the pair engine's,
   a profile of one call;
5. a JSON line of the kernels, the card line again, and the result line.

Every path runs with the launch counters set to 0 just before it and read
just after; each kernel must have launched on the path that reaches it.
The script needs the repository (it imports tpu_ec_torch and builds
native/src/ec_native.cpp); it imports nothing of JAX.  Without a CUDA
device it exits non-zero before printing any result.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import re
import subprocess
import sys
import time

SEED = 20240601
CHUNK = 1 << 18  # rows per call of a plain version (bounds its temporaries)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
IMAD_PER_CLOCK_SM = 64  # 32-bit integer multiply-adds per clock per SM (sm_90)
# field products of a point op, the bounds' count: G1 (Fq), and G2 in Fq
# products (an Fq2 product 3, an Fq2 square 2: 2M + 5S, 11M + 5S, 7M + 4S)
FQ_PRODUCTS = {"double": 7, "add": 16, "add_mixed": 11}
FP2_PRODUCTS = {"double": 16, "add": 43, "add_mixed": 29}


def card_line() -> str:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return res.stdout.strip().splitlines()[0]


def max_sm_clock_hz() -> float:
    res = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return float(res.stdout.strip().splitlines()[0]) * 1e6


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


def cuda_ms_once(fn):
    """(fn(), device milliseconds of that one call), for a plain version that
    takes seconds."""
    import torch

    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    out = fn()
    end.record()
    torch.cuda.synchronize()
    return out, start.elapsed_time(end)


def chunked(fn, *arrays, axis: int = 0, rows: int = CHUNK):
    """Run a plain version over chunks of ``rows`` along ``axis`` of its
    batched inputs."""
    import torch

    n = arrays[0].shape[axis]
    outs = [fn(*(a.narrow(axis, lo, min(rows, n - lo)) for a in arrays)) for lo in range(0, n, rows)]
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
    """n points k*G with random 64-bit k (native scalar mul) on ``nc``'s
    curve: the Jacobian (n, 3w) and affine (n, 2w) u64 arrays of the native
    layout."""
    import numpy as np

    G = nc.affine_from_points([(nc.spec.gen_x, nc.spec.gen_y)])
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    jac = nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks)
    return jac, nc.to_affine(jac)


def coords_from_u64(nc, arr, k: int, device):
    """k coordinates of a native (n, k*w) u64 array -> port tensors (G2:
    (n, 2L) each, c0 then c1)."""
    import torch

    w = nc.w
    return tuple(
        torch.as_tensor(nc.coord_to_halflimbs(arr[:, i * w : (i + 1) * w]).astype("int64"))
        .to(device=device, dtype=torch.int32)
        for i in range(k)
    )


def native_affine(nc, P):
    """Port Jacobian coordinates -> native affine (n, 2w) u64."""
    return nc.to_affine(affine_to_u64(nc, P))


def affine_to_u64(nc, xy):
    """Port coordinates (an affine (x, y), or Jacobian) -> the native u64 layout."""
    import numpy as np

    return np.concatenate([nc.coord_from_halflimbs(c.cpu().numpy().astype(np.uint64)) for c in xy], axis=1)


# kernel name in the mangled symbol -> label; a tuple is indexed by the op
# (the second template argument)
KERNEL_LABELS = (
    ("mont_mul_kernel", "K1 mont_mul"), ("inter_kernel", "K2 inter"), ("inter_i8_kernel", "K2 inter int8"),
    ("point_kernel", ("K3 add", "K3 add_mixed", "K3 double")), ("horner_kernel", "K3 horner"),
    ("point2_kernel", ("K3 add", "K3 add_mixed", "K3 double")),
    ("double_to", "K3 double_to (device function of the adds)"),
    ("double2_to", "K3 double_to (device function of the adds)"),
    ("scalar_mul_kernel", "K3 scalar_mul chain"), ("ec_fft_stage_kernel", "K3 ec_fft_stage"),
    ("lattice_kernel", "K3 lattice"),
    ("ntt_leaf_kernel", ("K4 ntt_leaf", "K4 ntt_leaf+level")), ("pease_rows_kernel", "K5 pease_rows"),
    ("pease_stage_kernel", "K5 pease_stage (rows too long for one block)"),
    ("affine_kernel", ("K7 affine_denom", "K7 affine_apply", "K6 coz_apply")),
    ("apply_kernel", "K7 affine_apply"), ("mul_chain_kernel", "mul_chain (the chains' product latency)"),
)


def kernel_label(name: str) -> str:
    """Label of a kernel's mangled (ptxas) or demangled (profiler) name; K3's
    Fq2 (G2) instances get " fp2" after the label."""
    args = re.findall(r"Li(\d+)E", name) or re.findall(r"(?<=[<, ])(\d+)(?=[>,])", name)
    fp2 = " fp2" if any(t in name for t in ("point2_kernel", "double2_to", "TileProducts2")) else ""
    for key, label in KERNEL_LABELS:
        if key in name:
            if isinstance(label, tuple):
                label, args = label[int(args[1])], args[:1]
            return f"{label}{fp2}<{','.join(args)}>" if args else label + fp2
    return name


def graph_ms(fn, iters: int = 20) -> float:
    """Device milliseconds per call of ``fn``, a kernel wrapper: ``iters``
    calls captured in one CUDA graph and replayed, so the device runs them
    back to back and the host's launch cost between them is not timed (CUDA
    events around eager calls time that cost where it exceeds the kernel)."""
    import torch

    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(iters):
            fn()
    g.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    g.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def traced(fn, label: str, attempts: int = 3) -> tuple[dict, float, list]:
    """device_split of one call of ``fn``, traced again where a trace holds no
    device time: torch.profiler at times records nothing of a call (seen in
    this script's traces of the fused NTT and of radix_fft_many, on the
    parent's code and on this one's).  Fails the run if every trace is
    empty."""
    for _ in range(attempts):
        got = device_split(fn)
        if got is not None:
            return got
        print(f"profile {label}: the trace holds no device time; tracing again", flush=True)
    raise SystemExit(f"profile {label}: {attempts} traces held no device time")


def device_split(fn) -> tuple[dict, float, list] | None:
    """One call of ``fn`` under torch.profiler: ({hand-kernel label: [device
    ms, launches]}, device-busy ms, the six largest other device ops as
    (name, ms, count)), or None where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    split, busy, others = {}, 0.0, []
    for ev in prof.key_averages():
        if ev.device_type != DeviceType.CUDA:
            continue
        ms = ev.self_device_time_total / 1e3
        busy += ms
        label = kernel_label(ev.key)
        if label != ev.key:
            label = label.split("<")[0]
            split.setdefault(label, [0.0, 0])
            split[label][0] += ms
            split[label][1] += ev.count
        else:
            others.append((ev.key, ms, ev.count))
    others = sorted(others, key=lambda o: -o[1])[:6]
    return (split, busy, others) if busy > 0 else None


def ptxas_summary(report: str) -> list[str]:
    """One line per kernel: registers and spill bytes from ``-Xptxas -v``."""
    lines, name = [], None
    for ln in report.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", ln) or re.search(
            r"Function properties for (\S+)", ln)
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
    return [f"{kernel_label(e[0])}: {', '.join(e[1:][::-1])}" for e in lines]


def sass_mix(lib_path: str, kernel: str) -> str:
    """Instruction counts of one kernel of the built library (cuobjdump
    -sass): IMAD.WIDE (one 32x32->64 multiply-add, two of mont_imads'
    IMADs), the other IMADs without IMAD.MOV (a move), IADD3, and all."""
    cuobjdump = os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "cuobjdump")
    res = subprocess.run([cuobjdump, "-sass", lib_path], capture_output=True, text=True, check=True,
                         timeout=300)
    counts, cur = {"wide": 0, "imad": 0, "iadd3": 0, "all": 0}, None
    for ln in res.stdout.splitlines():
        if (m := re.search(r"Function : (\S+)", ln)):
            cur = m.group(1)
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(?:@!?U?P\w+\s+)?([A-Z][A-Z0-9_.]*)", ln)
        if m and cur and kernel in cur:
            op = m.group(1)
            counts["all"] += 1
            if op.startswith("IMAD.WIDE"):
                counts["wide"] += 1
            elif op.startswith("IMAD") and not op.startswith("IMAD.MOV"):
                counts["imad"] += 1
            elif op.startswith("IADD3"):
                counts["iadd3"] += 1
    return (f"{counts['wide']} IMAD.WIDE + {counts['imad']} other IMAD (IMAD.MOV not counted) = "
            f"{2 * counts['wide'] + counts['imad']} IMAD-equivalents, {counts['iadd3']} IADD3, "
            f"{counts['all']} instructions")


def fp2_build_lines(report: str, sizes: dict) -> list[str]:
    """One line per Fq2 (G2) kernel of K3: registers and spill bytes from
    ``-Xptxas -v`` (a non-inlined callee's properties are its own), SASS
    instructions from ``sizes``."""
    from tpu_ec_torch.utils.fp2_probe import ptxas

    return [f"{kernel_label(k)}: {r} regs, spill stores {sp} B, {sizes.get(k, 0)} SASS instructions"
            for k, (r, sp) in ptxas(report).items() if kernel_label(k).split("<")[0].endswith("fp2")]


def mont_imads(nw: int) -> int:
    """32-bit IMADs of one CIOS Montgomery product of nw words: 2 nw^2 + nw
    32x32->64 multiply-adds, each a low and a high IMAD."""
    return 2 * (2 * nw * nw + nw)


class Kernels:
    """What the JSON line reports of each kernel: its source, the TPU kernel
    it replaces, and this run's measurements and bound."""

    INFO = {
        "mont_mul": ("csrc/mont.cu", "tpu_ec/ops/pallas/mont.py:337"),
        "inter_twiddle": ("csrc/inter.cu", "tpu_ec/ops/ntt_digit.py:381"),
        "inter_twiddle_i8": ("csrc/inter.cu", "tpu_ec/ops/ntt_digit.py:381"),
        "point": ("csrc/point.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "point_horner": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "point_horner_batch": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "point_scalar_mul": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "ec_fft_stage": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "point_lattice": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        # K3's Fq2 instances (G2; tpu_ec runs G2 on jnp, through no Pallas kernel)
        "point_fp2": ("csrc/point.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "point_horner_fp2": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "point_scalar_mul_fp2": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "ec_fft_stage_fp2": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "point_lattice_fp2": ("csrc/chain.cuh", "tpu_ec/ops/pallas/point.py:244"),
        "ntt_leaf": ("csrc/ntt.cu", "tpu_ec/ops/pallas/ntt_fused.py:65"),
        "ntt_leaf_level": ("csrc/ntt.cu", "tpu_ec/ops/pallas/ntt_fused.py:65"),
        "pease_stage": ("csrc/ntt.cu", "tpu_ec/ops/pallas/ntt.py:39"),
        "pease_stages": ("csrc/ntt.cu", "tpu_ec/ops/pallas/ntt.py:39"),
        "coz_apply": ("csrc/affine.cu", "tpu_ec/ops/pallas/affine.py:232"),
        "affine_denom": ("csrc/affine.cu", "tpu_ec/ops/pallas/affine.py:75"),
        "affine_apply": ("csrc/affine.cu", "tpu_ec/ops/pallas/affine.py:107"),
    }

    def __init__(self, imad_rate: float):
        self.imad_rate = imad_rate
        self.rows: dict[str, dict] = {}
        self.launches: dict[str, int] = {}

    def measured(self, name, *, ms, plain_ms, err, nbytes, imads, serial_ms=0.0):
        """A kernel's row: its bound is the larger of its bytes over the memory
        rate, its IMADs over the card's IMAD rate and, for a chain, its
        products in series at one product's latency (``serial_ms``, an
        operations bound too)."""
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = max(imads / self.imad_rate * 1e3, serial_ms)
        self.rows[name] = dict(
            ms=ms, plain_ms=plain_ms, max_abs_err=max(err, self.rows.get(name, {}).get("max_abs_err", 0)),
            bound_ms=max(t_bytes, t_ops), bound_by="bytes" if t_bytes >= t_ops else "operations",
        )

    def err(self, name, err):
        self.rows.setdefault(name, {})
        self.rows[name]["max_abs_err"] = max(err, self.rows[name].get("max_abs_err", 0))

    def json_line(self) -> str:
        out = []
        for name, (src, rep) in self.INFO.items():
            r = self.rows[name]
            out.append({
                "name": name, "route": "cuda", "source": f"tpu_ec_torch/{src}", "replaces": rep,
                "launches": self.launches[name], "max_abs_err": r["max_abs_err"],
                "ms": round(r["ms"], 4), "plain_ms": round(r["plain_ms"], 4),
                "bound_ms": r["bound_ms"], "bound_by": r["bound_by"], "library_ms": None,
            })
        return json.dumps({"kernels": out})


def horner_work(S, w: int, products: dict | None = None) -> tuple[int, int]:
    """(product levels of the longest chain, Fq products of all chains) of
    the Horner combine on window sums S, (W, L) or (W, C, L) coordinates, as
    K3's Horner entry runs it: a doubling 3 levels (``products["double"]``
    products: 7 on G1, 16 on G2), run once the result is not all zero; an
    add 5 levels (16, or 43), run where both the result and the window sum
    have z != 0 (an identity operand is a copy).  The result counts as
    nonzero from the first nonzero sum on."""
    products = products or FQ_PRODUCTS
    X, Y, Z = (c if c.dim() == 3 else c.unsqueeze(1) for c in S)
    nz = ((X != 0) | (Y != 0) | (Z != 0)).any(-1).long()  # (W, C)
    zn = (Z != 0).any(-1).long()
    above = lambda m: (m.flip(0).cumsum(0).flip(0) - m) > 0  # some window above j, added before it
    dbl = above(nz).long() * w
    add = (above(zn) & (zn > 0)).long()
    return int((3 * dbl + 5 * add).sum(0).max()), int((products["double"] * dbl + products["add"] * add).sum())


def on_path(kernels_mod, report: Kernels | None, owned: tuple, label: str, fn, rows: dict | None = None):
    """Run one path with the launch counters set to 0 just before it and
    read just after; the kernels it owns must each have launched.  Their
    counts go to the report rows of the same name, or to ``rows[name]``
    (none where ``report`` is None)."""
    kernels_mod.reset_launch_counters()
    out = fn()
    launches = kernels_mod.launch_counters()
    print(f"{label} launches: { {k: v for k, v in launches.items() if v} }", flush=True)
    missing = [k for k in owned if launches[k] == 0]
    if missing:
        raise SystemExit(f"{label} launched no {missing}")
    for k in owned if report is not None else ():
        report.launches[(rows or {}).get(k, k)] = launches[k]
    return out


def profile_ec_fft(log_n: int) -> int:
    """One BLS12-381 G1 EC-FFT of 2^log_n random points under torch.profiler,
    in a process of its own (a process that has traced before may record
    only part of a transform's launches); up to three traces until one
    holds every stage launch.  Prints one JSON line: the device split, busy
    ms, the largest other device ops, the traces taken."""
    import numpy as np
    import torch

    from tpu_ec_torch import kernels
    from tpu_ec_torch.curves.params import BLS12_381_G1
    from tpu_ec_torch.kernels import build
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.ec_fft import EcFftKernel

    build.load()
    nc = native_curve(BLS12_381_G1)
    P = coords_from_u64(nc, random_points(nc, np.random.default_rng(SEED), 1 << log_n)[0], 3, torch.device("cuda"))
    kern = EcFftKernel(BLS12_381_G1)
    kern.radix_ec_fft(P)  # the tables and the module's first load stay out of the trace
    torch.cuda.synchronize()
    for attempt in range(1, 4):
        kernels.reset_launch_counters()
        got = device_split(lambda: kern.radix_ec_fft(P))
        launches = kernels.launch_counters()["ec_fft_stage"]
        if got is not None and got[0].get("K3 ec_fft_stage", [0, 0])[1] == launches == log_n:
            split, busy, others = got
            print(json.dumps({"split": split, "busy": busy, "others": others, "attempts": attempt}))
            return 0
        traced = None if got is None else got[0].get("K3 ec_fft_stage", [0, 0])[1]
        print(f"trace {attempt}: {traced} of {launches} stage launches", file=sys.stderr)
    return 1


def chain_steps(k) -> tuple[list, list]:
    """(doubles, adds) of each chain of K3's chain entry on the plain
    scalars k (n, 16): a double a bit below the top set bit, an add a set
    bit below it."""
    import numpy as np

    kn = k.reshape(-1, k.shape[-1]).cpu().numpy().astype(np.int64)
    vals = [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in kn]
    return [max(v.bit_length() - 1, 0) for v in vals], [max(bin(v).count("1") - 1, 0) for v in vals]


def chain_counts(k):
    """(doubles, adds, the longest chain's product levels: 3 a double, 5 an
    add) of K3's chain entry on the plain scalars k."""
    dbls, adds = chain_steps(k)
    return sum(dbls), sum(adds), max(3 * d + 5 * a for d, a in zip(dbls, adds))


def host_ms(fn):
    """(ms per call or batch, mean of 3, and the three runs): host clock
    around synchronised calls."""
    import torch

    runs = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        runs.append((time.perf_counter() - t0) * 1e3)
    return sum(runs) / 3, runs


def scalar_ints_dot(ks, s) -> int:
    """sum_i k_i s_i for u64 k (n,) < 2^63 and (n, 16) half-limb s, exact:
    16-bit pieces of both, one int64 matrix product (each sum < 2^52)."""
    import numpy as np

    k16 = np.stack([(ks >> np.uint64(16 * a)) & np.uint64(0xFFFF) for a in range(4)], axis=1).astype(np.int64)
    m = k16.T @ s.astype(np.int64)  # (4, 16)
    return sum(int(m[a, b]) << (16 * (a + b)) for a in range(4) for b in range(16))


def phase_g2(log_n: int, dev, report, check, card: str, lat: dict, imad_rate: float) -> None:
    """Phase 4g: G2 on the card (the MSM at 2^log_n, the batch, scalar
    multiplication, the EC-FFT, a commit, and K3's Fq2 instances against
    their plain versions)."""
    import numpy as np
    import torch

    from tpu_ec_torch import kernels
    from tpu_ec_torch.curves.params import BLS12_381_G2, BN254_G2
    from tpu_ec_torch.fields.params import BLS12_381_FQ, BLS12_381_FR, BN254_FQ, BN254_FR
    from tpu_ec_torch.kernels import build
    from tpu_ec_torch.kernels.point import (chain_tile, ec_fft_stage, ec_fft_stage_plain, horner, horner_plain,
                                            point_op, point_op_plain, point_scalar_mul, scalar_mul_plain)
    from tpu_ec_torch.native import native_curve, native_field
    from tpu_ec_torch.ops.ec_fft import EcFftKernel
    from tpu_ec_torch.ops.msm import SCALAR_BITS, MultiexpKernel, make_digits
    from tpu_ec_torch.ops.autotune import tuned_window
    from tpu_ec_torch.ops.msm_scan import (_shifted_add, _unfuse, bucket_tail, default_window_size_scan, scan_buckets,
                                           scan_keep, sorted_rows)
    from tpu_ec_torch.ops.pipeline import CommitPipeline
    from tpu_ec_torch.utils.fp2_probe import sass_sizes

    t_g2 = time.perf_counter()
    rng = np.random.default_rng(SEED + 3)  # its own seed: the other phases' inputs stay the parent's
    n = 1 << log_n
    nc, nc_bn = native_curve(BLS12_381_G2), native_curve(BN254_G2)
    nfr, nfr_bn = native_field(BLS12_381_FR), native_field(BN254_FR)
    L2 = 2 * BLS12_381_FQ.n_limbs  # a G2 coordinate: 48 half-limbs (BLS12-381), 32 (BN254)
    imad12, imad8 = mont_imads(12), mont_imads(8)

    # K3's Fq2 instances as built: registers, spills and code size; their units' nvcc seconds
    for ln in fp2_build_lines(build.ptxas_report(), sass_sizes(build.library_path())):
        print(f"build fp2: {ln}", flush=True)
    secs = build.unit_seconds()
    print(f"build fp2: nvcc seconds {({k: v for k, v in secs.items() if k.startswith('g2_')})}, the G1 units' "
          f"longest {max(v for k, v in secs.items() if not k.startswith('g2_'))}; the point kernel on two lanes "
          f"a row, the chains on a tile of {chain_tile(BN254_FQ, 2)} lanes (8 words) and "
          f"{chain_tile(BLS12_381_FQ, 2)} (12 words)", flush=True)

    def op_latency(fq, P):
        """Device ms of one Fq2 point op in series: a one-point chain over
        2^256 - 1 (255 doublings and 255 adds) on one tile."""
        ones = torch.full((1, 16), 0xFFFF, dtype=torch.int32, device=dev)
        return cuda_ms(lambda: point_scalar_mul(fq, [c[:1] for c in P], ones, ext=2)) / 510

    # the main path: MultiexpKernel(BLS12_381_G2).multiexp, "auto", at 2^log_n
    t0 = time.perf_counter()
    G = nc.affine_from_points([(BLS12_381_G2.gen_x, BLS12_381_G2.gen_y)])
    ks = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    k4 = np.zeros((n, 4), dtype=np.uint64)
    k4[:, 0] = ks
    jac = nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), k4)
    aff = nc.to_affine(jac)
    scal_np = random_field(rng, BLS12_381_FR, n)  # plain Fr integers, rows 0-2: 0, 1, r - 1
    t_in = time.perf_counter() - t0
    msm = MultiexpKernel(BLS12_381_G2)
    ops = msm.ops
    bases = msm.upload_bases(coords_from_u64(nc, aff, 2, dev))
    scal = torch.as_tensor(scal_np).to(dev, torch.int32)
    chunk = msm.chunk_size
    chunks = -(-n // chunk)
    m = min(n, chunk)
    w = tuned_window(BLS12_381_G2.name, "scan", m) or default_window_size_scan(m)  # as multiexp picks it
    got = on_path(kernels, report, ("point_fp2", "point_horner_fp2"), f"G2 MSM 2^{log_n}",
                  lambda: msm.multiexp(bases, scal))
    counts = kernels.launch_counters()
    # K3 launches of the scan engine: the segmented scan's rounds, the prefix
    # scan and the tree of the tail, one Horner, a chunk; one add a further chunk
    want_k3 = chunks * ((m - 1).bit_length() + 2 * (w - 1) + 1) + chunks - 1
    if counts["point_fp2"] != want_k3 or counts["point_horner_fp2"] != chunks or counts["point"]:
        raise SystemExit(f"G2 MSM: K3 launches {counts}; the scan engine predicts {want_k3} Fq2 launches, "
                         f"{chunks} of them the Horner's, and no G1 launch")
    t0 = time.perf_counter()
    total = scalar_ints_dot(ks, scal_np) % BLS12_381_G2.scalar.modulus
    want = nc.to_affine(nc.scalar_mul(G, nc.scalars_from_ints([total])))
    if not np.array_equal(native_affine(nc, got), want):
        raise SystemExit(f"G2 MSM 2^{log_n}: the commitment is not (sum k_i s_i) G2")
    t_ref = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ms, runs = host_ms(lambda: msm.multiexp(bases, scal))
    peak = torch.cuda.max_memory_allocated()
    model = 10 * 20 * L2 * 4 * m  # calc_chunk_size's working set of a chunk
    print(f"G2 MSM BLS12-381 2^{log_n} ('auto' = scan: {counts['point_fp2']} Fq2 K3 launches, the rounds predict "
          f"{want_k3}, {counts['point_horner_fp2']} Horner, 0 G1): == (sum k_i s_i) G2 (one native scalar mul, "
          f"{t_ref:.1f} s; inputs {t_in:.1f} s of native scalar mul + to_affine); {ms:.1f} ms mean of 3 "
          f"({', '.join(f'{t:.1f}' for t in runs)}), {n / ms * 1e3:.0f} points/s; w = {w}, "
          f"{-(-SCALAR_BITS // w)} windows, {chunks} chunk(s) of {m}; peak {peak / 2**30:.2f} GiB (the chunk "
          f"model's working set {model / 2**30:.2f} GiB) | {card}", flush=True)

    split, busy, others = traced(lambda: msm.multiexp(bases, scal), "G2 MSM")
    k3_ms = sum(v[0] for k, v in split.items() if k.startswith("K3"))
    parts = ", ".join(f"{k} {v[0]:.4f} ms in {v[1]}" for k, v in sorted(split.items(), key=lambda kv: -kv[1][0]))
    print(f"profile G2 MSM 2^{log_n}: device busy {busy:.4f} ms, K3 {k3_ms:.4f} ms; hand kernels {parts}; largest "
          f"other device ops: " + "; ".join(f"{name[:60]} {t:.4f} ms in {cnt}" for name, t, cnt in others)
          + f" | {card}", flush=True)

    # the main path's first chunk: its signed digits, (1, W, m)
    half = 1 << (w - 1)
    sc = torch.cat([scal[:m], scal.new_zeros((m, 1))], dim=1)
    dig = make_digits(sc, w, -(-SCALAR_BITS // w), True).T.unsqueeze(0)
    pts = tuple(c[:m].unsqueeze(0) for c in bases)

    # K3's Fq2 add at the main path's shape: round 0 of the segmented scan,
    # the fused (W, m, 3 L2) block of the path's own sorted rows, each added
    # to the row before it unless kept (keep, out=, column views of row
    # stride 3 L2, the partner an offset view of the same rows), against the
    # plain version in chunks of 2^16 rows (its temporaries: ~125 KB a row,
    # as measured on the CPU); flat row 0 is kept, a copy
    key, data = sorted_rows(ops, pts, dig)
    keep = scan_keep(key, 1)
    del key
    run_r0 = lambda: _shifted_add(ops, data, 1, keep, L2)
    r0_ms = cuda_ms(run_r0)
    got = run_r0().view(-1, 3 * L2)
    a_rows, k_rows = data.view(-1, 3 * L2), keep.reshape(-1)
    r0_rows = a_rows.shape[0]
    bad, err = mismatch(got[:1], a_rows[:1])
    r0_plain = 0.0
    for lo in range(1, r0_rows, 1 << 16):
        hi = min(lo + (1 << 16), r0_rows)
        want, t = cuda_ms_once(lambda: point_op_plain(
            BLS12_381_FQ, "add", [*_unfuse(a_rows[lo:hi], L2, 3), *_unfuse(a_rows[lo - 1 : hi - 1], L2, 3)],
            k_rows[lo:hi], ext=2))
        r0_plain += t
        b_, e_ = mismatch(_unfuse(got[lo:hi], L2, 3), want)
        bad, err = bad + b_, max(err, e_)
    z_nonzero = (a_rows[:, 2 * L2 :] != 0).any(-1)
    adding = int((~k_rows[1:] & z_nonzero[1:] & z_nonzero[:-1]).sum())
    report.measured("point_fp2", ms=r0_ms, plain_ms=r0_plain, err=err, nbytes=r0_rows * (9 * L2 * 4 + 1),
                    imads=adding * FP2_PRODUCTS["add"] * imad12)
    print(f"K3 add fp2 at the main path's scan round 0 {tuple(data.shape)} keep + out=: mismatches {bad}, kernel "
          f"{r0_ms:.3f} ms, plain {r0_plain:.3f} ms", flush=True)
    if bad:
        raise SystemExit(f"K3 add fp2 scan round 0: the kernel disagrees with its plain version on {bad} rows")
    b_ms = report.rows["point_fp2"]["bound_ms"]
    print(f"K3 add fp2 scan round 0: {r0_ms:.4f} ms, bound {b_ms:.4f} ms ({adding} adding rows of {r0_rows} x 43 Fq "
          f"products x {imad12} IMADs; {report.rows['point_fp2']['bound_by']}), ms / bound {r0_ms / b_ms:.2f} "
          f"| {card}", flush=True)
    del data, keep, got, a_rows, k_rows, z_nonzero, want

    # the Horner at the main path's own window sums (the first chunk's)
    tri = bucket_tail(ops, scan_buckets(ops, pts, dig, half=half), half)
    S = _unfuse(tri[0], L2, 3)
    del dig, tri, pts
    want_h, p_ms = cuda_ms_once(lambda: horner_plain(BLS12_381_FQ, S, w, ext=2))
    h_ms = cuda_ms(lambda: horner(BLS12_381_FQ, S, w, ext=2))
    levels, prods = horner_work(S, w, FP2_PRODUCTS)
    check("point_horner_fp2", f"K3 horner fp2 ({S[0].shape[0]}, {L2}) w={w}", horner(BLS12_381_FQ, S, w, ext=2),
          want_h, h_ms, p_ms, nbytes=(S[0].shape[0] + 1) * 3 * L2 * 4, imads=prods * imad12,
          serial_ms=levels * lat[12])
    hb = report.rows["point_horner_fp2"]["bound_ms"]
    print(f"K3 horner fp2: {h_ms:.4f} ms, bound {hb:.4f} ms (operations in series: {levels} product levels x "
          f"{lat[12] * 1e3:.4f} us; {prods} Fq products), ms / bound {h_ms / hb:.2f} | {card}", flush=True)
    del S, want_h

    # 2^16 against the native Pippenger, both curves (the BLS12-381 bases
    # and scalars are the main path's first 2^16)
    n16 = min(n // 2, 1 << 16)
    for curve, ncv, nfv, fr, b, s_np in (
        (BLS12_381_G2, nc, nfr, BLS12_381_FR, bases, scal_np),
        (BN254_G2, nc_bn, nfr_bn, BN254_FR, None, None),
    ):
        if b is None:
            _, aff_c = random_points(ncv, rng, n16)
            b, s_np = coords_from_u64(ncv, aff_c, 2, dev), random_field(rng, fr, n16)
        else:
            aff_c = aff
        kern = msm if curve is BLS12_381_G2 else MultiexpKernel(curve)
        got = kern.multiexp(tuple(c[:n16] for c in b), torch.as_tensor(s_np[:n16]).to(dev, torch.int32))
        want = ncv.msm(aff_c[:n16], nfv.from_halflimbs(s_np[:n16].astype(np.uint64)))
        if not np.array_equal(native_affine(ncv, got), ncv.to_affine(want[None, :])):
            raise SystemExit(f"G2 MSM {curve.name} 2^16 disagrees with the native Pippenger MSM")
        ms16, _ = host_ms(lambda: kern.multiexp(tuple(c[:n16] for c in b),
                                                torch.as_tensor(s_np[:n16]).to(dev, torch.int32)))
        print(f"G2 MSM {curve.name} 2^{n16.bit_length() - 1}: == native Pippenger; {ms16:.2f} ms mean of 3 "
              f"| {card}", flush=True)

    # the batch: multiple_multiexp, 2^6 chunks x 2^10, every chunk against native
    nb = 1 << 10
    cb = min(64, n // nb)
    bs = random_field(rng, BLS12_381_FR, cb * nb)
    run_b = lambda: msm.multiple_multiexp(tuple(c[: cb * nb] for c in bases), torch.as_tensor(bs).to(dev, torch.int32),
                                          cb)
    out_b = run_b()
    s_u64 = nfr.from_halflimbs(bs.astype(np.uint64))
    want = np.stack([nc.msm(aff[c * nb : (c + 1) * nb], s_u64[c * nb : (c + 1) * nb]) for c in range(cb)])
    bad = int((native_affine(nc, out_b) != nc.to_affine(want)).any(axis=1).sum())
    if bad:
        raise SystemExit(f"G2 batch: {bad} of {cb} chunks disagree with the native Pippenger MSM")
    ms_b, runs_b = host_ms(run_b)
    print(f"G2 batch BLS12-381 {cb} x 2^10 (scan): every chunk == native Pippenger; {ms_b:.2f} ms mean of 3 "
          f"({', '.join(f'{t:.2f}' for t in runs_b)}), {cb * nb / ms_b * 1e3:.0f} points/s | {card}", flush=True)

    # K3's Fq2 point ops on 2^16 rows: 0 P = identity, 1 Q = A = identity,
    # 2 Q == P (other z) and A == P, 3 Q == -P and A == -P, 4 x = p - 1
    P = [c.clone() for c in coords_from_u64(nc, jac[:n16], 3, dev)]
    Q = [c.clone() for c in coords_from_u64(nc, jac[n16 : 2 * n16], 3, dev)]
    A = [c[n16 : 2 * n16].clone() for c in bases]
    PA = [c[:n16] for c in bases]
    for c in P:
        c[0] = 0
    for c in (*Q, *A):
        c[1] = 0
    F, lam = ops.F, ops.F.from_ints([(5, 7)])
    lam2 = F.sqr(lam)
    for c, v in zip(Q, (F.mul(P[0][2:3], lam2), F.mul(P[1][2:3], F.mul(lam, lam2)), F.mul(P[2][2:3], lam))):
        c[2] = v[0]  # row 2: P's point, its z scaled by lam
    A[0][2], A[1][2] = PA[0][2], PA[1][2]
    Q[0][3], Q[2][3], Q[1][3] = P[0][3], P[2][3], ops.F.neg(P[1][3:4])[0]
    A[0][3], A[1][3] = PA[0][3], ops.F.neg(PA[1][3:4])[0]
    pm1 = torch.tensor([((BLS12_381_FQ.modulus - 1) >> (16 * i)) & 0xFFFF for i in range(L2 // 2)] * 2,
                       dtype=torch.int32, device=dev)
    P[0][4] = pm1
    adding = {"add": int(((P[2] != 0).any(-1) & (Q[2] != 0).any(-1)).sum()),
              "add_mixed": int(((P[2] != 0).any(-1) & ((A[0] != 0) | (A[1] != 0)).any(-1)).sum()),
              "double": n16}
    for op, ins in (("add", [*P, *Q]), ("add_mixed", [*P, *A]), ("double", [*P])):
        plain = lambda: chunked(lambda *c: point_op_plain(BLS12_381_FQ, op, list(c), ext=2), *ins, rows=1 << 16)
        want, p_ms = cuda_ms_once(plain)
        k_ms = cuda_ms(lambda: point_op(BLS12_381_FQ, op, ins, ext=2))
        check("point_fp2", f"K3 {op} fp2 n={n16}", point_op(BLS12_381_FQ, op, ins, ext=2), want, k_ms, p_ms)
        t_ops = adding[op] * FP2_PRODUCTS[op] * imad12 / imad_rate * 1e3
        print(f"K3 {op} fp2 n={n16}: {k_ms:.4f} ms, operations bound {t_ops:.4f} ms ({adding[op]} adding rows x "
              f"{FP2_PRODUCTS[op]} Fq products x {imad12} IMADs), ms / bound {k_ms / t_ops:.2f} | {card}", flush=True)
    keep = torch.zeros(n16, dtype=torch.bool, device=dev)
    keep[::3] = True
    fused = torch.empty((n16, 3 * L2), dtype=torch.int32, device=dev)
    for op, ins in (("add", [*P, *Q]), ("add_mixed", [*P, *A]), ("add_mixed", [*PA, *A])):
        kern = lambda: point_op(BLS12_381_FQ, op, ins, keep=keep, out=fused, ext=2)
        plain = lambda: chunked(lambda kk, *c: point_op_plain(BLS12_381_FQ, op, list(c), kk, ext=2), keep, *ins,
                                rows=1 << 16)
        want, p_ms = cuda_ms_once(plain)
        check("point_fp2", f"K3 {op} fp2{' (P affine)' if len(ins) == 4 else ''} keep + out= n={n16}",
              tuple(c.clone() for c in kern()), want, cuda_ms(kern), p_ms)
    del P, Q, A, PA, fused, want

    # scalar multiplication: 1024 points, random scalars (rows 0-2: 0, 1, r - 1)
    h = 1024
    P1k = coords_from_u64(nc, jac[:h], 3, dev)
    k1k_np = random_field(rng, BLS12_381_FR, h)
    k1k = torch.as_tensor(k1k_np).to(dev, torch.int32)
    got = on_path(kernels, report, ("point_scalar_mul_fp2",), "G2 scalar_mul", lambda: ops.scalar_mul(P1k, k1k))
    want = nc.to_affine(nc.scalar_mul(aff[:h], nfr.from_halflimbs(k1k_np.astype(np.uint64))))
    if not np.array_equal(native_affine(nc, got), want):
        raise SystemExit("G2 scalar_mul disagrees with the native scalar multiplication")
    want_p, p_ms = cuda_ms_once(lambda: scalar_mul_plain(BLS12_381_FQ, P1k, k1k, ext=2))
    c_ms = cuda_ms(lambda: point_scalar_mul(BLS12_381_FQ, P1k, k1k, ext=2))
    dbls, adds, longest = chain_counts(k1k)
    prods = FP2_PRODUCTS["double"] * dbls + FP2_PRODUCTS["add"] * adds
    check("point_scalar_mul_fp2", f"K3 scalar_mul chain fp2 ({h}, {L2}), {dbls + adds} point ops", got, want_p, c_ms,
          p_ms, nbytes=(h * 6 * L2 + h * 16) * 4, imads=prods * imad12)
    cb_ = report.rows["point_scalar_mul_fp2"]["bound_ms"]
    op12 = op_latency(BLS12_381_FQ, P1k)
    print(f"K3 Fq2 chain entries: one point op in series {op12 * 1e3:.3f} us at 12 words (a one-point chain over "
          f"2^256 - 1, 510 ops) | {card}", flush=True)
    serial = longest * lat[12]
    print(f"K3 scalar_mul chain fp2: == native; {c_ms:.4f} ms, bound {cb_:.4f} ms (operations), ms / bound "
          f"{c_ms / cb_:.1f}; serial bound {serial:.4f} ms (the longest chain's {longest} product levels, 3 a "
          f"double and 5 an add, x {lat[12] * 1e3:.4f} us), ms / serial {c_ms / serial:.2f} | {card}", flush=True)
    del want_p, got, P1k

    # the EC-FFT at 2^11, both curves, forward and inverse
    lg = min(11, log_n)
    for curve, ncv, fq in ((BN254_G2, nc_bn, BN254_FQ), (BLS12_381_G2, nc, BLS12_381_FQ)):
        jac_e, _ = random_points(ncv, rng, 1 << lg)
        Pe = coords_from_u64(ncv, jac_e, 3, dev)
        kern = EcFftKernel(curve)
        run = lambda: kern.radix_ec_fft(Pe)
        out = on_path(kernels, report if curve is BN254_G2 else None, ("ec_fft_stage_fp2",),
                      f"G2 EC-FFT {curve.name} 2^{lg}", run)
        if kernels.launch_counters()["ec_fft_stage_fp2"] != lg:
            raise SystemExit(f"G2 EC-FFT 2^{lg}: not one stage launch a stage")
        if not np.array_equal(native_affine(ncv, out), ncv.to_affine(ncv.ec_fft(jac_e))):
            raise SystemExit(f"G2 EC-FFT {curve.name} 2^{lg} disagrees with the native EC-FFT")
        back = on_path(kernels, None, ("ec_fft_stage_fp2", "point_scalar_mul_fp2"), f"G2 EC-FFT inverse {curve.name}",
                       lambda: kern.radix_ec_fft(out, inverse=True))
        if not np.array_equal(native_affine(ncv, back), native_affine(ncv, Pe)):
            raise SystemExit(f"G2 EC-FFT {curve.name} 2^{lg}: the inverse does not give its input back")
        ms_f, runs_f = host_ms(run)
        ms_i, _ = host_ms(lambda: kern.radix_ec_fft(out, inverse=True))
        print(f"G2 EC-FFT {curve.name} 2^{lg}: == native EC-FFT, inverse == input; forward {ms_f:.2f} ms mean of 3 "
              f"({', '.join(f'{t:.2f}' for t in runs_f)}), {(1 << lg) / ms_f * 1e3:.0f} points/s; inverse "
              f"{ms_i:.2f} ms | {card}", flush=True)
        if curve is BN254_G2:
            print(f"K3 Fq2 chain entries: one point op in series {op_latency(fq, Pe) * 1e3:.3f} us at 8 words "
                  f"| {card}", flush=True)
            tw = kern._domain_tensors(lg, False)[0]
            hh = 1 << (lg - 1)
            want, p_ms = cuda_ms_once(lambda: ec_fft_stage_plain(fq, Pe, tw, 0, ext=2))
            s_ms = cuda_ms(lambda: ec_fft_stage(fq, Pe, tw, 0, ext=2))
            dbls, adds, longest = chain_counts(tw)
            prods = FP2_PRODUCTS["double"] * dbls + FP2_PRODUCTS["add"] * (adds + 2 * hh)
            check("ec_fft_stage_fp2", f"K3 ec_fft_stage fp2 stage 0 ({1 << lg}, {2 * fq.n_limbs}), {hh} butterflies",
                  ec_fft_stage(fq, Pe, tw, 0, ext=2), want, s_ms, p_ms,
                  nbytes=hh * (12 * 2 * fq.n_limbs + 16) * 4, imads=prods * imad8)
            sb = report.rows["ec_fft_stage_fp2"]["bound_ms"]
            serial = (10 + longest) * lat[8]
            print(f"K3 ec_fft_stage fp2: {s_ms:.4f} ms, bound {sb:.4f} ms (operations), ms / bound {s_ms / sb:.1f}; "
                  f"serial bound {serial:.4f} ms (an add, a sub and the longest chain: 10 + {longest} product levels "
                  f"x {lat[8] * 1e3:.4f} us), ms / serial {s_ms / serial:.2f} | {card}", flush=True)
            del want

    # a G2 commit at 2^16: NTT -> from_mont -> the scan MSM
    pipe = CommitPipeline(BLS12_381_G2)
    coeffs_np = random_field(rng, BLS12_381_FR, n16)
    coeffs = torch.as_tensor(coeffs_np).to(dev, torch.int32)
    cb16 = tuple(c[:n16] for c in bases)
    evals, com = on_path(kernels, None, ("mont_mul", "inter_twiddle", "point_fp2", "point_horner_fp2"),
                         f"G2 commit 2^{n16.bit_length() - 1}",
                         lambda: pipe.commit(coeffs, cb16))
    want_e = nfr.ntt(nfr.from_halflimbs(coeffs_np.astype(np.uint64)))
    if not np.array_equal(nfr.from_halflimbs(evals.cpu().numpy().astype(np.uint64)), want_e):
        raise SystemExit("G2 commit: the evaluations disagree with the native NTT")
    if not np.array_equal(native_affine(nc, com), nc.to_affine(nc.msm(aff[:n16], nfr.from_mont(want_e))[None, :])):
        raise SystemExit("G2 commit: the commitment disagrees with the native Pippenger MSM")
    ms_c, runs_c = host_ms(lambda: pipe.commit(coeffs, cb16))
    print(f"G2 commit BLS12-381 2^{n16.bit_length() - 1}: evaluations == native NTT, commitment == native Pippenger; {ms_c:.2f} ms mean "
          f"of 3 ({', '.join(f'{t:.2f}' for t in runs_c)}) | {card}", flush=True)
    print(f"phase 4g: {time.perf_counter() - t_g2:.1f} s", flush=True)


def digit_launches(dom, M: int = 1) -> tuple[dict, int]:
    """({kernel: launches} of one digit-NTT call of 2^log_n x M with its
    tables built, K1 launches that build the tables), from the domain's plan
    and routes: an unchunked level is one K2 pass; a chunked one a K2 pass a
    slice and, with factored seeds, log2(c) K1 launches for the base rows
    and popcount(slice) for each slice's row of powers; the last GEMM is
    one K2 pass a slice of the batch axis when chunked, and the final pass
    K2 on int32 columns, or on int8 digits (its own entry) when chunked.  A
    table built with K1 takes log2(n1) launches for its row of powers,
    log2(n2) for the rows and log2(n2) - 1 squarings; factored seeds the
    same less the rows."""
    k1 = k2 = build = 0
    chunked = (1 << dom.log_n) * M >= dom.chunk_min
    log_m = dom.log_n
    for lf in dom.plan[:-1]:
        log_n1, n2 = log_m - lf, 1 << lf
        route = dom.inter[(log_m, log_n1)]
        route = route if isinstance(route, str) else "host"
        if chunked or route == "factored":
            nc = min(dom.chunk_count, n2)
            k2 += nc
            if route == "factored":
                k1 += (n2 // nc).bit_length() - 1 + sum(bin(ci).count("1") for ci in range(nc))
        else:
            k2 += 1
        if route in ("device", "factored"):
            build += log_n1 + (lf if route == "device" else 0) + lf - 1
        log_m, M = log_n1, M * n2
    if chunked:
        k2 += min(dom.chunk_count, M)
    else:
        k2 += 1
    return {"mont_mul": k1, "inter_twiddle": k2, "inter_twiddle_i8": int(chunked)}, build


def phase_ntt_large(dev, report, check, card: str) -> None:
    """Phase 4h: the digit NTT at 2^22, 2^24 and 2^26 (``FftKernel.radix_fft``
    on BLS12-381 Fr, through the default routes), the other route at 2^26,
    BN254 Fr at 2^22 on the chunked route, ``digit_ntt_planes_batch`` at
    (2^13, 2^11), and K2's int8 entry at the final pass's shape."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from tpu_ec_torch import kernels
    from tpu_ec_torch.fields.params import BLS12_381_FR, BN254_FR
    from tpu_ec_torch.kernels import build
    from tpu_ec_torch.kernels.inter import inter_twiddle, inter_twiddle_plain
    from tpu_ec_torch.native import native_field
    from tpu_ec_torch.ops import ntt_digit as nd
    from tpu_ec_torch.ops.ntt import FftKernel

    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + 4)  # its own seed: the other phases' inputs stay the parent's
    referee = ThreadPoolExecutor(1)  # the native NTT runs beside the card's first calls (ctypes frees the GIL)
    shifts = torch.tensor([0, 16, 32, 48], dtype=torch.int64, device=dev)

    def rand_fr(spec, *shape):
        """Random canonical elements (< p's top limb) as int32 half-limbs on the card."""
        x = torch.randint(0, 1 << 16, (*shape, 16), generator=gen, device=dev, dtype=torch.int32)
        x[..., -1] = torch.randint(0, int(spec.p_limbs[-1]), shape, generator=gen, device=dev, dtype=torch.int32)
        return x

    def words(x, block: int = 1 << 22):
        """(n, 16) half-limbs on the card -> the native (n, 4) u64 words."""
        return np.concatenate([(x[s : s + block].to(torch.int64).view(-1, 4, 4) << shifts).sum(-1).cpu().numpy()
                               for s in range(0, x.shape[0], block)]).view(np.uint64)

    def routes(dom):
        return ", ".join(f"2^{lm}: {v if isinstance(v, str) else 'host'}" for (lm, _), v in dom.inter.items())

    def run_size(spec, log_n, label, owned, report_rows=None, profile=False):
        """First call, inverse, launches against the plan, native check, ms
        and peaks of one size; returns the forward output."""
        nf = native_field(spec)
        x = rand_fr(spec, 1 << log_n)
        want = referee.submit(nf.ntt, words(x))
        k = FftKernel(spec, dev)
        dom = nd.get_digit_domain(spec, log_n, False, nd.leaf_log(log_n))
        chunked = (1 << log_n) >= dom.chunk_min
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = on_path(kernels, report if report_rows is not None else None, owned, f"{label} first call",
                    lambda: k.radix_fft(x), rows=report_rows)
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak_first = torch.cuda.max_memory_allocated()
        per_call, build = digit_launches(dom)
        kernels.reset_launch_counters()
        y2 = k.radix_fft(x)
        got = {name: kernels.launch_counters()[name] for name in per_call}
        if got != per_call or not torch.equal(y, y2):
            raise SystemExit(f"{label}: launches {got} != the plan's {per_call}, or a second call differs")
        back = k.radix_fft(y, inverse=True)
        if not torch.equal(back, x):
            raise SystemExit(f"{label}: the inverse does not give the input back")
        del back, y2
        bad = int((words(y) != want.result()).any(axis=1).sum())
        if bad:
            raise SystemExit(f"{label}: {bad} rows disagree with the native NTT")
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: k.radix_fft(x), iters=3)
        ms_inv = cuda_ms(lambda: k.radix_fft(x, inverse=True), iters=3)
        peak = torch.cuda.max_memory_allocated()
        if profile:
            split, busy, others = traced(lambda: k.radix_fft(x), label)
            print(f"profile {label}: device busy {busy:.4f} ms; hand kernels "
                  + ", ".join(f"{name} {v[0]:.4f} ms in {v[1]}" for name, v in split.items())
                  + "; largest other device ops " + "; ".join(f"{o[0][:90]} {o[1]:.4f} ms in {o[2]}" for o in others)
                  + f" | {card}", flush=True)
        print(f"{label}: plan {dom.plan}, level tables {routes(dom)}, "
              f"{'chunked' if chunked else 'unchunked'} ({dom.chunk_count} slices from 2^"
              f"{dom.chunk_min.bit_length() - 1}); == native NTT on all {1 << log_n} rows, inverse == input; "
              f"first call {first_s:.2f} s (tables included, peak {peak_first / 2**30:.2f} GiB); "
              f"{ms:.3f} ms mean of 3 forward, {ms_inv:.3f} ms inverse; peak {peak / 2**30:.2f} GiB "
              f"({(peak - base) / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held: input, output, tables); "
              f"launches a call {got} == the plan's, tables' K1 launches {build} a direction | {card}",
              flush=True)
        return k, x, y, ms, peak

    for log_n in (22, 24):
        run_size(BLS12_381_FR, log_n, f"NTT 2^{log_n} BLS12-381 Fr", ("mont_mul", "inter_twiddle"))
        torch.cuda.empty_cache()
    dom26 = nd.get_digit_domain(BLS12_381_FR, 26, False, nd.leaf_log(26))
    chunked26 = (1 << 26) >= dom26.chunk_min
    owned = ("mont_mul", "inter_twiddle", "inter_twiddle_i8") if chunked26 else ("mont_mul", "inter_twiddle")
    k, x, y, ms, peak = run_size(BLS12_381_FR, 26, "NTT 2^26 BLS12-381 Fr", owned,
                                 report_rows={"mont_mul": "mont_mul@ntt26", "inter_twiddle": "inter_twiddle@ntt26"},
                                 profile=True)
    del k
    torch.cuda.empty_cache()

    # the route the constants did not pick at 2^26, on the same input
    saved = nd._CHUNK_MIN
    nd._CHUNK_MIN = 1 << 27 if chunked26 else 1 << 26
    try:
        other = "unchunked" if chunked26 else "chunked"
        k_o = FftKernel(BLS12_381_FR, dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        y_o = on_path(kernels, None if chunked26 else report,
                      ("inter_twiddle",) if chunked26 else ("mont_mul", "inter_twiddle", "inter_twiddle_i8"),
                      f"NTT 2^26 {other} first call", lambda: k_o.radix_fft(x),
                      rows={"mont_mul": "mont_mul@ntt26", "inter_twiddle": "inter_twiddle@ntt26"})
        torch.cuda.synchronize()
        first_o = time.perf_counter() - t0
        if not torch.equal(y_o, y):
            raise SystemExit(f"NTT 2^26: the {other} route disagrees with the default route")
        del y_o
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        ms_o = cuda_ms(lambda: k_o.radix_fft(x), iters=3)
        peak_o = torch.cuda.max_memory_allocated()
        print(f"NTT 2^26 {other} route: == the default route; first call {first_o:.2f} s; {ms_o:.3f} ms mean of "
              f"3 vs {ms:.3f} ms default; peak {peak_o / 2**30:.2f} GiB ({(peak_o - base) / 2**30:.2f} above "
              f"the {base / 2**30:.2f} GiB held) vs {peak / 2**30:.2f} GiB default | {card}", flush=True)
        del k_o
    finally:
        nd._CHUNK_MIN = saved
    del x, y
    torch.cuda.empty_cache()

    # BN254 Fr at 2^22 on the chunked route
    nd._CHUNK_MIN = 1 << 22
    try:
        run_size(BN254_FR, 22, "NTT 2^22 BN254 Fr (chunked forced)", ("mont_mul", "inter_twiddle", "inter_twiddle_i8"))
    finally:
        nd._CHUNK_MIN = saved
    torch.cuda.empty_cache()

    # digit_ntt_planes_batch at (2^13, 2^11): a 2^26 four-step split's local stage on one of four shards
    nb, B = 1 << 13, 1 << 11
    xb = rand_fr(BLS12_381_FR, nb, B).permute(2, 0, 1).contiguous()  # (16, n, B) planes
    yb = on_path(kernels, None, ("inter_twiddle",), f"digit_ntt_planes_batch (2^13, 2^11)",
                 lambda: nd.digit_ntt_planes_batch(BLS12_381_FR, xb))
    nf = native_field(BLS12_381_FR)
    cols = torch.randperm(B, generator=gen, device=dev)[:16].tolist()
    for b in cols:
        if not np.array_equal(words(yb[:, :, b].T.contiguous()), nf.ntt(words(xb[:, :, b].T.contiguous()))):
            raise SystemExit(f"digit_ntt_planes_batch: column {b} disagrees with the native NTT")
    if not torch.equal(nd.digit_ntt_planes_batch(BLS12_381_FR, yb, True), xb):
        raise SystemExit("digit_ntt_planes_batch: the inverse batch does not give the input back")
    ms_b = cuda_ms(lambda: nd.digit_ntt_planes_batch(BLS12_381_FR, xb), iters=3)
    print(f"digit_ntt_planes_batch (2^13, 2^11): 16 sampled columns == native NTT, inverse batch == input; "
          f"{ms_b:.3f} ms mean of 3 | {card}", flush=True)
    del xb, yb
    torch.cuda.empty_cache()

    # K2's int8 entry (its own kernel, a tile of columns a block) at the
    # final pass's shape, (37, n) digits in, canonical (n, 16) rows out, at
    # n = 2^26 and 2^20; its bound is bytes, 37 in and 64 out a column
    c = torch.as_tensor(dom26.final_c.astype(np.int64)).to(dev, torch.int32)
    kw = dict(canonical=True, const_t=True)
    i8 = {}
    for log_n in (20, 26):
        n = 1 << log_n
        dig = torch.randint(0, 128, (37, n), generator=gen, device=dev, dtype=torch.int8)
        want, p_ms = cuda_ms_once(lambda: chunked(lambda d: inter_twiddle_plain(BLS12_381_FR, d, c, **kw), dig,
                                                  axis=1, rows=1 << 19))
        got = inter_twiddle(BLS12_381_FR, dig, c, out_rows=True, **kw)
        k_ms = cuda_ms(lambda: inter_twiddle(BLS12_381_FR, dig, c, out_rows=True, **kw))
        bound = n * (37 + 16 * 4) / HBM_BYTES_PER_S * 1e3
        check("inter_twiddle_i8", f"K2 inter int8 entry (37, 2^{log_n}) int8 x const T -> canonical rows "
              f"(2^{log_n}, 16), the final pass", got, want.T, k_ms, p_ms,
              **(dict(nbytes=n * (37 + 16 * 4), imads=n * 2 * 153) if log_n == 26 else {}))
        i8[log_n] = (k_ms, bound, p_ms)
        del dig, want, got
        torch.cuda.empty_cache()
    # a ragged n (odd, not a multiple of the tile): both canonical layouts
    n = 3 * (1 << 16) + 77
    dig = torch.randint(0, 128, (37, n), generator=gen, device=dev, dtype=torch.int8)
    want = inter_twiddle_plain(BLS12_381_FR, dig, c, **kw)
    check("inter_twiddle_i8", f"K2 inter int8 entry (37, {n}) -> planes", inter_twiddle(BLS12_381_FR, dig, c, **kw),
          want, 0.0, 0.0)
    check("inter_twiddle_i8", f"K2 inter int8 entry (37, {n}) -> rows",
          inter_twiddle(BLS12_381_FR, dig, c, out_rows=True, **kw), want.T, 0.0, 0.0)
    del dig, want
    regs = "; ".join(ln for ln in ptxas_summary(build.ptxas_report()) if ln.startswith("K2"))
    i32 = report.rows["inter_twiddle"]
    print("K2 int8 entry: " + ", ".join(f"(37, 2^{lg}) {k:.4f} ms, bound {b:.4f} ms (bytes), ms / bound "
                                        f"{k / b:.2f}, plain {p:.3f} ms" for lg, (k, b, p) in i8.items())
          + f"; == plain at (37, {n}) planes and rows; K2 int32 level 0 (phase 3) {i32['ms']:.4f} ms, bound "
          f"{i32['bound_ms']:.4f} ms, ms / bound {i32['ms'] / i32['bound_ms']:.2f}; ptxas {regs} | {card}",
          flush=True)
    referee.shutdown()
    torch.cuda.empty_cache()
    print(f"phase 4h: {time.perf_counter() - t_phase:.1f} s", flush=True)


def lattice_work(digits, nbuckets: int, ext: int) -> tuple[int, int]:
    """(product levels of the busiest lane, Fq products of all lanes) of K3's
    lattice entry on this run's (m, lanes) digits (the bases hold no
    identity): a lane's mixed adds of a nonzero digit (5 levels, 11 products
    on G1, 29 on G2), less each slot's first, a copy into an empty bucket;
    its reduction's adds with both operands nonzero (5 levels, 16 or 43):
    running + bucket k below the top occupied slot where bucket k is
    occupied, acc + running at every slot below the top one."""
    import numpy as np

    products = FQ_PRODUCTS if ext == 1 else FP2_PRODUCTS
    d = np.abs(digits.cpu().numpy().astype(np.int64))  # (m, lanes)
    nz = (d != 0).sum(0)
    occupied = np.zeros((nbuckets, d.shape[1]), dtype=bool)
    occupied[d, np.arange(d.shape[1])[None, :]] = True
    occupied[0] = False
    slots = occupied.sum(0)
    top = np.where(slots > 0, nbuckets - 1 - np.argmax(occupied[::-1], axis=0), 0)
    madds = nz - slots
    adds = np.maximum(slots - 1, 0) + np.maximum(top - 1, 0)
    return int((5 * (madds + adds)).max()), int(products["add_mixed"] * madds.sum() + products["add"] * adds.sum())


def phase_lattice(dev, card: str, nc, bases_aff, commit_ms: float, log_n: int, report, lat: dict) -> None:
    """Phase 4i: the bucket lattice on BLS12-381 at full width, each output
    against the native Pippenger: ``multiexp(signed=False)`` ("auto" = the
    lattice) and ``method="lattice"`` signed on G1 at 2^16 (phase 4's first
    points), ``multiexp_1bit`` on the same, an unsigned G2 lattice at 2^12;
    ms, K3 launches against ``lattice_steps`` (one lattice entry each), peak
    memory; K3's lattice entry against its plain version on the two
    unsigned cases' own operands, timed and bounded (the busiest lane's
    product levels in series, the products at the IMAD rate, the bytes), and
    on small lattices at 8 and 12 words and on Fq2, both signs; for the G1
    unsigned case the device time by kernel (torch.profiler); then the
    window the table gives the commit."""
    import numpy as np
    import torch

    from tpu_ec_torch import kernels
    from tpu_ec_torch.curves.params import BLS12_381_G1, BLS12_381_G2, BN254_G1
    from tpu_ec_torch.fields.params import BLS12_381_FR
    from tpu_ec_torch.kernels.point import lattice_lanes, lattice_lanes_plain
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.autotune import tuned_window
    from tpu_ec_torch.ops.msm import (SCALAR_BITS, MultiexpKernel, default_num_groups, default_window_size,
                                      lattice_steps, make_digits, multiexp_1bit, prepare_inputs)
    from tpu_ec_torch.ops.msm_pair import default_window_size_pair

    t_phase = time.perf_counter()
    rng = np.random.default_rng(SEED + 5)  # its own seed: the other phases' inputs stay the parent's
    g1 = MultiexpKernel(BLS12_381_G1, dev)
    m1 = 1 << min(16, log_n)
    ncg2 = native_curve(BLS12_381_G2)
    m2 = 1 << min(12, log_n)
    g2 = MultiexpKernel(BLS12_381_G2, dev)
    aff2 = random_points(ncg2, rng, m2)[1]
    imad_rate = report.imad_rate

    def operands(bases, scal, w, G, signed):
        """The lattice entry's operands as ``msm_lattice`` builds them."""
        (x, y), s, m = prepare_inputs(bases, scal, G)
        W = -(-SCALAR_BITS // w)
        digits = make_digits(s.reshape(m * G, -1), w, W, signed).reshape(m, G * W)
        return x, y, digits, (1 << (w - 1) if signed else (1 << w) - 1) + 1

    def hold(name, label, spec, x, y, digits, nb, signed, timed):
        """The entry against its plain version on the same operands; with
        ``timed``, its row: ms, plain ms, the bound."""
        base, ext = spec.base, spec.ext
        got = lattice_lanes(base, x, y, digits, nb, signed, ext)
        want, p_ms = cuda_ms_once(lambda: lattice_lanes_plain(base, x, y, digits, nb, signed, ext))
        bad, err = mismatch(tuple(c.reshape(-1, c.shape[-1]) for c in got),
                            tuple(c.reshape(-1, c.shape[-1]) for c in want))
        m, lanes = digits.shape
        if not timed:
            report.err(name, err)
            print(f"K3 lattice {label} (m {m}, {lanes} lanes, nbuckets {nb}): mismatches {bad}, plain {p_ms:.1f} ms",
                  flush=True)
        else:
            k_ms = cuda_ms(lambda: lattice_lanes(base, x, y, digits, nb, signed, ext))
            levels, prods = lattice_work(digits, nb, ext)
            nw = base.n_limbs // 2
            L = x.shape[-1]
            nbytes = 4 * (2 * x.shape[0] * x.shape[1] * L + m * lanes + 3 * lanes * L)
            report.measured(name, ms=k_ms, plain_ms=p_ms, err=err, nbytes=nbytes, imads=prods * mont_imads(nw),
                            serial_ms=levels * lat[nw])
            r = report.rows[name]
            print(f"K3 lattice {label} (m {m}, {lanes} lanes, nbuckets {nb}): mismatches {bad}, kernel {k_ms:.4f} ms, "
                  f"plain {p_ms:.1f} ms; bound {r['bound_ms']:.4f} ms ({r['bound_by']}: the busiest lane's {levels} "
                  f"product levels x {lat[nw] * 1e3:.4f} us = {levels * lat[nw]:.4f} ms; {prods} Fq products x "
                  f"{mont_imads(nw)} IMADs = {prods * mont_imads(nw) / imad_rate * 1e3:.4f} ms; bytes "
                  f"{nbytes / HBM_BYTES_PER_S * 1e3:.4f} ms), ms / bound {k_ms / r['bound_ms']:.2f} | {card}",
                  flush=True)
        if bad:
            raise SystemExit(f"K3 lattice {label}: the kernel disagrees with its plain version on {bad} lanes")

    # the entry on small lattices: 8 and 12 words, Fq2, both signs (an
    # identity base, a zero scalar, a point and scalar on two steps in a row)
    for spec, n, w, G in ((BN254_G1, 1 << 10, 4, 16), (BLS12_381_G1, 1 << 10, 4, 16), (BLS12_381_G2, 1 << 8, 2, 8)):
        ncs = native_curve(spec)
        aff = random_points(ncs, rng, n)[1]
        aff[0] = 0
        aff[2 + G] = aff[2]
        s_np = random_field(rng, BLS12_381_FR, n)  # rows 0-2: 0, 1, r - 1
        s_np[2 + G] = s_np[2]
        s_np[1] = 0
        bases = coords_from_u64(ncs, aff, 2, dev)
        scal = torch.as_tensor(s_np).to(dev, torch.int32)
        for signed in (False, True):
            x, y, digits, nb = operands(bases, scal, w, G, signed)
            hold("point_lattice" if spec.ext == 1 else "point_lattice_fp2",
                 f"{spec.name} n {n} w {w} G {G} {'signed' if signed else 'unsigned'}", spec, x, y, digits, nb,
                 signed, False)

    cases = (
        ("G1 multiexp(signed=False) ('auto' = lattice)", g1, nc, bases_aff[:m1], None, False,
         lambda b, s: g1.multiexp(b, s, signed=False)),
        ("G1 multiexp(method='lattice') signed", g1, nc, bases_aff[:m1], None, True,
         lambda b, s: g1.multiexp(b, s, method="lattice")),
        ("G1 multiexp_1bit", g1, nc, bases_aff[:m1], 1, False,
         lambda b, s: multiexp_1bit(BLS12_381_G1, b, s, device=dev)),
        ("G2 multiexp(signed=False) ('auto' = lattice)", g2, ncg2, aff2, None, False,
         lambda b, s: g2.multiexp(b, s, signed=False)),
    )
    for label, kern, ncv, aff, w, signed, run in cases:
        n = aff.shape[0]
        ext = kern.spec.ext
        s_np = random_field(rng, BLS12_381_FR, n)  # plain Fr integers, rows 0-2: 0, 1, r - 1
        bases = kern.upload_bases(coords_from_u64(ncv, aff, 2, dev))
        scal = torch.as_tensor(s_np).to(dev, torch.int32)
        w = w or default_window_size(n)
        G = default_num_groups(n, w)
        m = -(-n // G)
        steps = lattice_steps(G)
        owned = (("point", "point_horner", "point_lattice") if ext == 1 else
                 ("point_fp2", "point_horner_fp2", "point_lattice_fp2"))
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        got = on_path(kernels, None, owned, f"{label} 2^{n.bit_length() - 1}", lambda: run(bases, scal))
        counts = kernels.launch_counters()
        peak = torch.cuda.max_memory_allocated() - base
        want_k3 = sum(steps.values())
        other = "point" if ext == 2 else "point_fp2"
        if (counts[owned[0]] != want_k3 or counts[owned[1]] != steps["horner"]
                or counts[owned[2]] != steps["lattice"] or counts[other]):
            raise SystemExit(f"{label}: K3 launches {counts}; the lattice predicts {want_k3} ({steps})")
        if not signed and w > 1:  # the "auto" paths: the lattice entry's launches on the main path
            report.launches[owned[2]] = counts[owned[2]]
        want = ncv.to_affine(ncv.msm(aff, ncv.fr.from_halflimbs(s_np.astype(np.uint64)))[None, :])
        if not np.array_equal(native_affine(ncv, got), want):
            raise SystemExit(f"{label}: the result disagrees with the native Pippenger")
        ms, runs = host_ms(lambda: run(bases, scal))
        print(f"{label} 2^{n.bit_length() - 1}: == native Pippenger; {ms:.2f} ms mean of 3 "
              f"({', '.join(f'{t:.2f}' for t in runs)}); w = {w}, G = {G}, {m} steps; K3 launches "
              f"{counts[owned[0]]} == the plan's {want_k3} ({steps}); peak {peak / 2**30:.3f} GiB above the inputs "
              f"| {card}", flush=True)
        if not signed and w > 1:
            x, y, digits, nb = operands(bases, scal, w, G, signed)
            hold(owned[2], f"{kern.spec.name} 2^{n.bit_length() - 1} w {w} G {G} unsigned (the path's operands)",
                 kern.spec, x, y, digits, nb, signed, True)
            del x, y, digits
        if ext == 1 and not signed and w > 1:
            split, busy, _ = traced(lambda: run(bases, scal), label)
            k3 = {k: v for k, v in split.items() if k.startswith("K3")}
            print(f"{label} 2^{n.bit_length() - 1} device time: busy {busy:.4f} ms; K3 "
                  f"{ {k: [round(v[0], 4), v[1]] for k, v in k3.items()} } | {card}", flush=True)
        del bases, scal, got
        torch.cuda.empty_cache()
    n = 1 << log_n
    w_tab, w_model = tuned_window(BLS12_381_G1.name, "pair", n), default_window_size_pair(n)
    print(f"commit 2^{log_n}: the pair engine's window from the table {w_tab} (the model's {w_model}); the commit "
          f"{commit_ms:.1f} ms mean of 3 (phase 4) | {card}", flush=True)
    print(f"phase 4i: {time.perf_counter() - t_phase:.1f} s", flush=True)


def phase_dist(dev, card: str, pipe, bases, scalars, commitment, many_in, many_out) -> None:
    """Phase 4j: the multi-device layer (``tpu_ec_torch.parallel``) in an
    NCCL process group of world size 1 on cuda:0, started here from a
    FileStore: ``dryrun_multichip(1)`` (its own spawned rank); the
    distributed NTT at 2^26 (digit route) against the single-card transform
    on every row, its inverse against the input, K1 / K2 / K2-int8 launches
    of a call against the plan's, a profile of one call; the distributed MSM on phase 4's bases and
    scalars with both accumulations against the commitment; the
    distributed EC-FFT of phase 4f's batch; the sorted engine against the
    commitment, beside the pair engine.  One rank a card: NCCL refuses two
    ranks of one communicator on one card, so the exchanges here are
    degenerate; d >= 2 runs in the CPU tests (gloo)."""
    import shutil
    import tempfile

    import torch
    import torch.distributed as dist

    from tpu_ec_torch import kernels
    from tpu_ec_torch.config import get_config
    from tpu_ec_torch.curves.params import BLS12_381_G1, BN254_G1
    from tpu_ec_torch.entry import dryrun_multichip
    from tpu_ec_torch.fields.params import BLS12_381_FR
    from tpu_ec_torch.ops import ntt_digit as nd
    from tpu_ec_torch.ops.msm import MultiexpKernel
    from tpu_ec_torch.ops.msm_sorted import default_window_size_sorted, sorted_steps
    from tpu_ec_torch.ops.ntt import FftKernel
    from tpu_ec_torch.parallel import DistEcFftKernel, DistFftKernel, DistMultiexpKernel, make_mesh, shard_leading
    from tpu_ec_torch.parallel.msm_dist import dist_window

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    tmp = tempfile.mkdtemp()
    torch.cuda.set_device(0)
    # a group started with no backend named ("cpu:gloo,cuda:nccl" on a card)
    # puts the mesh on the card as an NCCL group does; its probe is a K1
    # launch and an all_gather through NCCL
    dist.init_process_group(store=dist.FileStore(os.path.join(tmp, "store0"), 1), rank=0, world_size=1)
    try:
        backends, m0 = dist.get_backend_config(), make_mesh(probe=True)
    finally:
        dist.destroy_process_group()
    if m0 is None or m0.device.type != "cuda":
        raise SystemExit(f"a process group with backends {backends!r} put the mesh on {m0 and m0.device}")
    print(f"phase 4j: a group with no backend named ({backends}) gives {m0}", flush=True)
    dist.init_process_group("nccl", store=dist.FileStore(os.path.join(tmp, "store"), 1), rank=0, world_size=1)
    try:
        mesh = make_mesh()
        print(f"phase 4j: process group backend {dist.get_backend()}, world size {dist.get_world_size()}, {mesh}",
              flush=True)
        t0 = time.perf_counter()
        dryrun_multichip(1)
        print(f"dryrun_multichip(1): the 2^14 NTT == ntt_ref, the 2^10 MSM == native Pippenger, in a spawned NCCL "
              f"rank; {time.perf_counter() - t0:.1f} s | {card}", flush=True)

        # the distributed NTT at 2^26 (n1 = n2 = 2^13, the digit route's local stages)
        log_n, spec = 26, BLS12_381_FR
        gen = torch.Generator(device=dev)
        gen.manual_seed(SEED + 6)  # its own seed: the other phases' inputs stay the parent's
        x = torch.randint(0, 1 << 16, (1 << log_n, 16), generator=gen, device=dev, dtype=torch.int32)
        x[:, -1] = torch.randint(0, int(spec.p_limbs[-1]), (1 << log_n,), generator=gen, device=dev,
                                 dtype=torch.int32)
        single = FftKernel(spec, dev)
        y_single = single.radix_fft(x)
        del single
        torch.cuda.empty_cache()
        kern = DistFftKernel(spec, mesh)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        y = on_path(kernels, None, ("mont_mul", "inter_twiddle"), "distributed NTT 2^26 first call",
                    lambda: kern.radix_fft(shard_leading(x, mesh)))
        torch.cuda.synchronize()
        first_s = time.perf_counter() - t0
        peak_first = torch.cuda.max_memory_allocated() - base
        plan = kern.plan(log_n, False)
        if not plan.digit:
            raise SystemExit("distributed NTT 2^26: the local stages did not take the digit route")
        bad = int((y != y_single).any(dim=1).sum())
        if bad:
            raise SystemExit(f"distributed NTT 2^26: {bad} rows disagree with the single-card transform")
        del y_single
        want = {"mont_mul": 1, "inter_twiddle": 0, "inter_twiddle_i8": 0}  # K1: the twiddle multiply
        for ln, M in ((plan.log_n1, plan.n2 // mesh.size), (plan.log_n2, plan.n1 // mesh.size)):
            for k, v in digit_launches(nd.get_digit_domain(spec, ln, False, nd.leaf_log(ln)), M)[0].items():
                want[k] += v
        kernels.reset_launch_counters()
        y2 = kern.radix_fft(x)
        got = {k: kernels.launch_counters()[k] for k in want}
        if got != want or not torch.equal(y, y2):
            raise SystemExit(f"distributed NTT 2^26: launches {got} != the plan's {want}, or a second call differs")
        del y2
        back = kern.radix_fft(y, inverse=True)
        if not torch.equal(back, x):
            raise SystemExit("distributed NTT 2^26: the inverse does not give the input back")
        del back
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        ms = cuda_ms(lambda: kern.radix_fft(x), iters=3)
        ms_inv = cuda_ms(lambda: kern.radix_fft(y, inverse=True), iters=3)
        peak = torch.cuda.max_memory_allocated() - base
        split, busy, others = traced(lambda: kern.radix_fft(x), "distributed NTT 2^26")
        print(f"profile distributed NTT 2^26: device busy {busy:.4f} ms; hand kernels "
              + ", ".join(f"{name} {v[0]:.4f} ms in {v[1]}" for name, v in split.items())
              + "; largest other device ops " + "; ".join(f"{o[0][:90]} {o[1]:.4f} ms in {o[2]}" for o in others)
              + f" | {card}", flush=True)
        print(f"distributed NTT 2^26 BLS12-381 Fr (d = 1, n1 = n2 = 2^13, digit local stages): == the single-card "
              f"transform on all {1 << log_n} rows, inverse == input; first call {first_s:.2f} s (twiddle slice and "
              f"tables included, peak {peak_first / 2**30:.2f} GiB above the input); {ms:.3f} ms mean of 3 forward, "
              f"{ms_inv:.3f} ms inverse; peak {peak / 2**30:.2f} GiB above the {base / 2**30:.2f} GiB held; "
              f"launches a call {got} == the plan's | {card}", flush=True)
        del kern, x, y
        torch.cuda.empty_cache()

        # the distributed MSM on phase 4's bases and scalars, both accumulations
        n = scalars.shape[0]
        ops = pipe.ops
        want_aff = ops.to_affine(commitment)
        cfg = get_config()
        saved = cfg.dist_msm_accum
        owned = ("point", "point_horner", "point_scalar_mul")
        try:
            for accum in ("pair", "scan"):
                cfg.dist_msm_accum = accum
                dk = DistMultiexpKernel(BLS12_381_G1, mesh)
                run = lambda: dk.multiexp(shard_leading(bases, mesh), shard_leading(scalars, mesh))
                torch.cuda.synchronize()
                base = torch.cuda.memory_allocated()
                torch.cuda.reset_peak_memory_stats()
                out = on_path(kernels, None, owned, f"distributed MSM 2^{n.bit_length() - 1} {accum}", run)
                counts = {k: kernels.launch_counters()[k] for k in owned}
                peak = torch.cuda.max_memory_allocated() - base
                if not all(torch.equal(a, b) for a, b in zip(ops.to_affine(out), want_aff)):
                    raise SystemExit(f"distributed MSM ({accum}) disagrees with the commitment")
                ms, runs = host_ms(run)
                print(f"distributed MSM 2^{n.bit_length() - 1} BLS12-381 G1 accum {accum} (d = 1): == the commitment "
                      f"(affine); {ms:.2f} ms mean of 3 ({', '.join(f'{t:.2f}' for t in runs)}); window "
                      f"{dist_window(n, mesh.size)}; K3 launches {counts}; peak {peak / 2**30:.2f} GiB above the "
                      f"inputs | {card}", flush=True)
                del out
                torch.cuda.empty_cache()
        finally:
            cfg.dist_msm_accum = saved

        # the distributed EC-FFT of phase 4f's batch
        stacked = tuple(torch.stack(cs) for cs in zip(*many_in))
        want_ec = tuple(torch.stack(cs) for cs in zip(*many_out))
        ek = DistEcFftKernel(BN254_G1, mesh)
        run = lambda: ek.radix_ec_fft_many(shard_leading(stacked, mesh))
        out = on_path(kernels, None, ("ec_fft_stage",), f"distributed EC-FFT 16 x {stacked[0].shape[1]}", run)
        if not all(torch.equal(a, b) for a, b in zip(out, want_ec)):
            raise SystemExit("distributed EC-FFT disagrees with phase 4f's batch")
        ms, runs = host_ms(run)
        print(f"distributed EC-FFT BN254 G1 16 x 2^{stacked[0].shape[1].bit_length() - 1} (d = 1): == phase 4f's "
              f"batch; {ms:.3f} ms mean of 3 ({', '.join(f'{t:.3f}' for t in runs)}) | {card}", flush=True)

        # the sorted engine on phase 4's data, one engine call (chunk_size n)
        mk = MultiexpKernel(BLS12_381_G1, dev, chunk_size=n)
        w = default_window_size_sorted(n)
        steps = sorted_steps(n, w)
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        out = on_path(kernels, None, ("point", "point_horner"), f"sorted MSM 2^{n.bit_length() - 1}",
                      lambda: mk.multiexp(bases, scalars, method="sorted"))
        counts = {k: kernels.launch_counters()[k] for k in ("point", "point_horner")}
        peak = torch.cuda.max_memory_allocated() - base
        if counts != {"point": sum(steps.values()), "point_horner": 1}:
            raise SystemExit(f"sorted MSM: K3 launches {counts}; sorted_steps predicts {steps}")
        if not all(torch.equal(a, b) for a, b in zip(ops.to_affine(out), want_aff)):
            raise SystemExit("sorted MSM disagrees with the commitment")
        ms, runs = host_ms(lambda: mk.multiexp(bases, scalars, method="sorted"))
        pair_ms, _ = host_ms(lambda: mk.multiexp(bases, scalars, method="pair"))
        split, busy, others = traced(lambda: mk.multiexp(bases, scalars, method="sorted"), "sorted MSM")
        print(f"profile sorted MSM 2^{n.bit_length() - 1}: device busy {busy:.4f} ms; hand kernels "
              + ", ".join(f"{name} {v[0]:.4f} ms in {v[1]}" for name, v in split.items())
              + "; largest other device ops " + "; ".join(f"{o[0][:90]} {o[1]:.4f} ms in {o[2]}" for o in others)
              + f" | {card}", flush=True)
        print(f"sorted MSM 2^{n.bit_length() - 1} BLS12-381 G1: == the commitment (affine); {ms:.2f} ms mean of 3 "
              f"({', '.join(f'{t:.2f}' for t in runs)}) against the pair engine's {pair_ms:.2f} ms; w = {w}; K3 "
              f"launches {counts['point']} == sorted_steps {steps}; peak {peak / 2**30:.2f} GiB above the inputs "
              f"| {card}", flush=True)
        del out
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    torch.cuda.empty_cache()
    print(f"phase 4j: {time.perf_counter() - t_phase:.1f} s", flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--log-n", type=int, default=20, help="input size 2^log_n (default 20)")
    ap.add_argument("--profile-ec-fft", type=int, metavar="LOG_N",
                    help="only trace one BLS12-381 EC-FFT of 2^LOG_N points (phase 4f runs this)")
    args = ap.parse_args()

    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device available", file=sys.stderr)
        return 1
    if args.profile_ec_fft is not None:
        return profile_ec_fft(args.profile_ec_fft)
    import numpy as np

    from tpu_ec_torch import kernels
    from tpu_ec_torch.config import get_config
    from tpu_ec_torch.curves.params import BLS12_381_G1, BN254_G1
    from tpu_ec_torch.fields.limbs import sub_borrow
    from tpu_ec_torch.fields.params import BLS12_381_FQ, BLS12_381_FR, BN254_FQ
    from tpu_ec_torch.kernels import affine as kaff
    from tpu_ec_torch.kernels import build
    from tpu_ec_torch.kernels.butterfly import (bit_reverse_index, pease_stage, pease_stage_plain, pease_stages,
                                                pease_stages_plain)
    from tpu_ec_torch.kernels.inter import inter_twiddle, inter_twiddle_plain
    from tpu_ec_torch.kernels.mont import mont_mul, mont_mul_plain
    from tpu_ec_torch.kernels.ntt_leaf import ntt_leaf, ntt_leaf_plain
    from tpu_ec_torch.kernels.point import (chain_tile, ec_fft_stage, ec_fft_stage_plain, horner, horner_plain,
                                            mul_chain, mul_chain_plain, point_op, point_op_plain, point_scalar_mul,
                                            scalar_mul_plain)
    from tpu_ec_torch.native import native_curve, native_field
    from tpu_ec_torch.ops.affine import affine_add_batch, batch_inverse, partial_products
    from tpu_ec_torch.ops.density import DensityTracker, compact_by_density
    from tpu_ec_torch.ops.ec_fft import EcFftKernel
    from tpu_ec_torch.ops.autotune import tuned_window
    from tpu_ec_torch.ops.msm import SCALAR_BITS, batch_slab
    from tpu_ec_torch.ops.msm_coz import _bucket_rows, _pair_up, default_window_size_coz
    from tpu_ec_torch.ops.msm_pair import (_bucket_rows, _pair_round, _unfuse, default_window_size_pair,
                                           msm_pair_buckets)
    from tpu_ec_torch.ops.msm_scan import bucket_tail
    from tpu_ec_torch.ops.msm_sorted import _plan_sizes
    from tpu_ec_torch.ops.ntt import FftKernel, get_domain
    from tpu_ec_torch.ops.ntt_digit import digit_consts, get_digit_domain, leaf_log
    from tpu_ec_torch.ops.ntt_fused import fused_consts, get_fused_domain
    from tpu_ec_torch.ops.pipeline import CommitPipeline
    from tpu_ec_torch.utils.measure import timeit

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED)
    n = 1 << args.log_n
    L_fr, L_fq = BLS12_381_FR.n_limbs, BLS12_381_FQ.n_limbs

    # 1. device
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    clock = max_sm_clock_hz()
    imad_rate = sms * IMAD_PER_CLOCK_SM * clock
    report = Kernels(imad_rate)
    print(f"device: {card} | torch {torch.__version__} cuda {torch.version.cuda} | {kind}", flush=True)
    print(f"bounds: {HBM_BYTES_PER_S / 1e12:.2f} TB/s; IMAD {sms} SMs x {IMAD_PER_CLOCK_SM}/clock x "
          f"{clock / 1e6:.0f} MHz = {imad_rate / 1e12:.3f} T/s", flush=True)

    # 2. build
    t_build = build.build()
    build.load()
    t0 = time.perf_counter()
    nc = native_curve(BLS12_381_G1)
    nfr = native_field(BLS12_381_FR)
    t_native = time.perf_counter() - t0
    print(f"build: kernels {t_build:.1f} s (0 = already built), native {t_native:.1f} s; nvcc seconds a unit "
          f"(all started together): {build.unit_seconds()}", flush=True)
    for ln in ptxas_summary(build.ptxas_report()):
        print(f"ptxas: {ln}", flush=True)
    print(f"sass: K1 mont_mul<12> (one 12-word product, its loads and stores): "
          f"{sass_mix(build.library_path(), 'mont_mul_kernelILi12E')}; mont_imads(12) = {mont_imads(12)}",
          flush=True)

    # one field product's latency on one thread (the unit of the chains'
    # serial bounds): a dependent chain of products, held against its plain
    # version (its own seed: the other phases' inputs stay the parent's)
    lat, rng_lat = {}, np.random.default_rng(SEED + 1)
    for spec in (BN254_FQ, BLS12_381_FQ):
        a1, b1 = (torch.as_tensor(random_field(rng_lat, spec, 4)[3]).to(dev, torch.int32) for _ in range(2))
        if not torch.equal(mul_chain(spec, a1, b1, 64), mul_chain_plain(spec, a1, b1, 64)):
            raise SystemExit(f"mul_chain {spec.name}: the kernel disagrees with its plain version")
        steps = 1 << 14
        lat[spec.n_limbs // 2] = cuda_ms(lambda: mul_chain(spec, a1, b1, steps)) / steps
        print(f"product latency {spec.name} ({spec.n_limbs // 2} words): {lat[spec.n_limbs // 2] * 1e3:.4f} us "
              f"(a chain of {steps} products on one thread, == plain on 64) | {card}", flush=True)

    def check(name, label, got, want, k_ms, p_ms, **bound):
        bad, err = mismatch(got, want)
        if bound:
            report.measured(name, ms=k_ms, plain_ms=p_ms, err=err, **bound)
        else:
            report.err(name, err)
        print(f"{label}: mismatches {bad}, kernel {k_ms:.3f} ms, plain {p_ms:.3f} ms", flush=True)
        if bad:
            raise SystemExit(f"{label}: the kernel disagrees with its plain version on {bad} rows")

    # 3. kernels against their plain versions, bit-exact
    for spec in (BLS12_381_FR, BLS12_381_FQ):
        a = torch.as_tensor(random_field(rng, spec, n)).to(dev, torch.int32)
        b = torch.as_tensor(random_field(rng, spec, n)[::-1].copy()).to(dev, torch.int32)
        plain = lambda: chunked(lambda x, y: mont_mul_plain(spec, x, y), a, b)
        check("mont_mul", f"K1 mont_mul {spec.name} n=2^{args.log_n}", mont_mul(spec, a, b), plain(),
              cuda_ms(lambda: mont_mul(spec, a, b)), cuda_ms(plain, iters=1))
    # the main path's K1 shape: from_mont of the 2^n evaluations
    unit = torch.zeros(L_fr, dtype=torch.int32, device=dev)
    unit[0] = 1
    evals_like = torch.as_tensor(random_field(rng, BLS12_381_FR, n)).to(dev, torch.int32)
    plain = lambda: chunked(lambda x: mont_mul_plain(BLS12_381_FR, x, unit), evals_like)
    check("mont_mul", f"K1 from_mont shape (2^{args.log_n}, 16) x (16,)",
          mont_mul(BLS12_381_FR, evals_like, unit), plain(),
          cuda_ms(lambda: mont_mul(BLS12_381_FR, evals_like, unit)), cuda_ms(plain, iters=1),
          nbytes=(2 * n + 1) * L_fr * 4, imads=n * mont_imads(L_fr // 2))

    dom = get_digit_domain(BLS12_381_FR, args.log_n, False, leaf_log(args.log_n))
    consts = digit_consts(dom, dev)
    col_bound = (1 << max(dom.plan)) * dom.d_in * 127 * 127
    shapes = []
    log_rest, M = args.log_n, 1
    for lf in dom.plan[:-1]:
        n1_log = log_rest - lf
        T = consts["inter"][(log_rest, n1_log)]  # (n2, n1, 16) rows; column i's twiddle is row i // M
        if isinstance(T, dict):
            break  # factored seeds: phase 4h holds K2's chunks
        shapes.append((f"level {len(shapes)} ({dom.d_leaf}, 2^{args.log_n}) x T rows {tuple(T.shape)}, "
                       f"t_rep {M} -> int8", T.view(-1, 16), M, dom.d_leaf))
        log_rest, M = n1_log, M * T.shape[0]
    shapes.append((f"final ({dom.d_leaf}, 2^{args.log_n}) x const T -> canonical (16, 2^{args.log_n})",
                   consts["final_c"], 0, dom.d_leaf))
    for i, (label, t16, t_rep, dc) in enumerate(shapes):
        cols = torch.as_tensor(rng.integers(0, col_bound, (dc, n), dtype=np.int64)).to(dev, torch.int32)
        if t_rep:
            kw = dict(t_rep=t_rep)
            t_cols = t16.repeat_interleave(t_rep, dim=0).T  # every column's twiddle, chunked with the columns
            plain = lambda: chunked(lambda c, t: inter_twiddle_plain(BLS12_381_FR, c, t.T), cols, t_cols, axis=1)
        else:
            kw = dict(canonical=True, const_t=True)
            plain = lambda: chunked(lambda c: inter_twiddle_plain(BLS12_381_FR, c, t16, **kw), cols, axis=1)
        got = inter_twiddle(BLS12_381_FR, cols, t16, **kw)
        # 9 x 8 words of v * T' and of m * p, 9 words of m: 153 multiply-adds
        bound = dict(nbytes=n * (dc * 4 + 16 * 4 + 37), imads=n * 2 * 153) if i == 0 else {}
        check("inter_twiddle", f"K2 inter {label}", got.T, plain().T,
              cuda_ms(lambda: inter_twiddle(BLS12_381_FR, cols, t16, **kw)), cuda_ms(plain, iters=1),
              **bound)
    # K2's int8 entry: the final pass after a chunked last GEMM, (37, 2^n)
    # digits in, canonical (2^n, 16) rows out as FftKernel takes them
    dig = torch.as_tensor(rng.integers(0, 128, (37, n), dtype=np.int64)).to(dev, torch.int8)
    kw = dict(canonical=True, const_t=True)
    plain = lambda: chunked(lambda c: inter_twiddle_plain(BLS12_381_FR, c, consts["final_c"], **kw), dig, axis=1)
    check("inter_twiddle_i8", f"K2 inter int8 entry (37, 2^{args.log_n}) int8 x const T -> canonical rows "
          f"(2^{args.log_n}, 16)", inter_twiddle(BLS12_381_FR, dig, consts["final_c"], out_rows=True, **kw),
          plain().T,
          cuda_ms(lambda: inter_twiddle(BLS12_381_FR, dig, consts["final_c"], out_rows=True, **kw)),
          cuda_ms(plain, iters=1),
          nbytes=n * (37 + 16 * 4), imads=n * 2 * 153)
    del dig

    npts = min(n, 1 << 16)
    jac, aff = random_points(nc, rng, 2 * npts)
    P = [c.clone() for c in coords_from_u64(nc, jac[:npts], 3, dev)]
    Q = [c.clone() for c in coords_from_u64(nc, jac[npts:], 3, dev)]
    A = [c.clone() for c in coords_from_u64(nc, aff[npts:], 2, dev)]
    PA = [c.clone() for c in coords_from_u64(nc, aff[:npts], 2, dev)]
    p_fq = torch.as_tensor(np.asarray(BLS12_381_FQ.p_limbs, np.int64), device=dev)
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
    Q[1][3] = sub_borrow(p_fq, P[1][3].to(torch.int64))[0].to(torch.int32)
    A[1][3] = sub_borrow(p_fq, PA[1][3].to(torch.int64))[0].to(torch.int32)
    for op, ins in (("add", [*P, *Q]), ("add_mixed", [*P, *A]), ("double", [*P])):
        plain = lambda: chunked(lambda *c: point_op_plain(BLS12_381_FQ, op, list(c)), *ins)
        check("point", f"K3 {op} n={npts}", point_op(BLS12_381_FQ, op, ins), plain(),
              cuda_ms(lambda: point_op(BLS12_381_FQ, op, ins)), cuda_ms(plain, iters=1))
    # the keep / out= entry: where(keep, P, P + Q) into fused rows
    keep16 = torch.zeros(npts, dtype=torch.bool, device=dev)
    keep16[::3] = True
    fused16 = torch.empty((npts, 3 * L_fq), dtype=torch.int32, device=dev)
    for op, ins in (("add", [*P, *Q]), ("add_mixed", [*P, *A]), ("add_mixed", [*PA, *A])):
        kern = lambda: point_op(BLS12_381_FQ, op, ins, keep=keep16, out=fused16)
        plain = lambda: chunked(lambda kk, *c: point_op_plain(BLS12_381_FQ, op, list(c), kk), keep16, *ins)
        check("point", f"K3 {op}{' (P affine)' if len(ins) == 4 else ''} keep + out= n={npts}",
              kern(), plain(), cuda_ms(kern), cuda_ms(plain, iters=1))
    # the Horner combine at the commit's shape: 19 window sums, w = 14
    wp = tuned_window(BLS12_381_G1.name, "pair", n) or default_window_size_pair(n)  # the commit's window
    nwin = -(-SCALAR_BITS // wp)
    S = [c[8 : 8 + nwin] for c in P]
    want, p_ms = cuda_ms_once(lambda: horner_plain(BLS12_381_FQ, S, wp))
    h_ms = cuda_ms(lambda: horner(BLS12_381_FQ, S, wp))
    levels, prods = horner_work(S, wp)
    check("point_horner", f"K3 horner ({nwin}, {L_fq}) w={wp}", horner(BLS12_381_FQ, S, wp), want, h_ms, p_ms,
          nbytes=(nwin + 1) * 3 * L_fq * 4, imads=prods * mont_imads(L_fq // 2), serial_ms=levels * lat[L_fq // 2])
    hb = report.rows["point_horner"]["bound_ms"]
    print(f"K3 horner: {h_ms:.4f} ms, bound {hb:.4f} ms (operations in series: one chain of {levels} product "
          f"levels x {lat[L_fq // 2] * 1e3:.4f} us, one product's latency; {prods} products), ms / bound "
          f"{h_ms / hb:.2f} | {card}", flush=True)

    # K5 at the shape of the 2^9 NTT batch of radix_fft_many (phase 4b): one
    # stage, then every stage with the bit reversal in one launch
    nb = max(1, n >> 9)
    y = torch.as_tensor(random_field(rng, BLS12_381_FR, nb * 512)).to(dev, torch.int32).reshape(nb, 512, L_fr)
    tw9 = torch.as_tensor(get_domain(BLS12_381_FR, 9).twiddles.astype(np.int64)).to(dev, torch.int32)
    row_bytes = (2 * nb * 512 + 256) * L_fr * 4
    for s in (0, 8):
        plain = lambda: chunked(lambda t: pease_stage_plain(BLS12_381_FR, t, tw9, s), y)
        bound = dict(nbytes=row_bytes, imads=nb * 256 * mont_imads(L_fr // 2))
        check("pease_stage", f"K5 pease_stage ({nb}, 512, 16) stage {s}",
              pease_stage(BLS12_381_FR, y, tw9, s), plain(),
              cuda_ms(lambda: pease_stage(BLS12_381_FR, y, tw9, s)), cuda_ms(plain, iters=1),
              **(bound if s == 0 else {}))
    whole = lambda: pease_stages(BLS12_381_FR, y, tw9, 0, 9, bitrev=True)
    plain = lambda: chunked(lambda t: pease_stages_plain(BLS12_381_FR, t, tw9, 0, 9, bitrev=True), y)
    want = plain()
    whole_ms = cuda_ms(whole)
    check("pease_stages", f"K5 pease_stages ({nb}, 512, 16) stages 0..8, bit-reversed", whole(), want,
          whole_ms, cuda_ms(plain, iters=1), nbytes=row_bytes, imads=9 * nb * 256 * mont_imads(L_fr // 2))
    rev9 = bit_reverse_index(9, dev)

    def staged():  # the staged form: nine one-stage launches, then the gather
        t = y
        for s in range(9):
            t = pease_stage(BLS12_381_FR, t, tw9, s)
        return t.index_select(1, rev9)

    if not torch.equal(staged(), want):
        raise SystemExit("K5: nine one-stage launches and the gather disagree with the plain transform")
    b5 = report.rows["pease_stages"]["bound_ms"]
    print(f"K5 whole transform: {whole_ms:.4f} ms, bound {b5:.4f} ms "
          f"({report.rows['pease_stages']['bound_by']}), ms / bound {whole_ms / b5:.2f}; nine one-stage "
          f"launches + gather {cuda_ms(staged):.4f} ms | {card}", flush=True)

    # K4 at the leaf shapes of the 2^n fused plan (forward tables)
    fdom = get_fused_domain(BLS12_381_FR, args.log_n, False)
    fcon = fused_consts(fdom, dev)
    ftw = fcon["leaf"]
    log_rest, first = args.log_n, True
    for lf in fdom.plan:
        m, B = 1 << lf, n >> lf
        x = torch.as_tensor(random_field(rng, BLS12_381_FR, n)).to(dev, torch.int32).reshape(m, B, L_fr)
        plain = lambda: chunked(lambda t: ntt_leaf_plain(BLS12_381_FR, t, ftw[lf]), x, axis=1)
        bound = dict(nbytes=(2 * n + lf * m // 2) * L_fr * 4, imads=B * (m // 2) * lf * mont_imads(L_fr // 2))
        check("ntt_leaf", f"K4 ntt_leaf ({m}, {B}, 16)", ntt_leaf(BLS12_381_FR, x, ftw[lf]), plain(),
              cuda_ms(lambda: ntt_leaf(BLS12_381_FR, x, ftw[lf])), cuda_ms(plain, iters=1),
              **(bound if first else {}))
        first = False
    # K4 with the level epilogue at the plan's level shapes, beside the
    # three steps it replaces (leaf, K1 by the expanded table, transpose copy)
    log_rest, B, first = args.log_n, 1, True
    for lf in fdom.plan[:-1]:
        n1_log = log_rest - lf
        m, n1 = 1 << lf, 1 << n1_log
        T = fcon["inter"][(log_rest, n1_log)]
        x = torch.as_tensor(random_field(rng, BLS12_381_FR, n)).to(dev, torch.int32).reshape(m, n1 * B, L_fr)
        kern = lambda: ntt_leaf(BLS12_381_FR, x, ftw[lf], level=(T, B))
        got, want = kern(), ntt_leaf_plain(BLS12_381_FR, x, ftw[lf], level=(T, B))
        T_rows = T[:, :, None, :].expand(m, n1, B, L_fr).reshape(m, n1 * B, L_fr).contiguous()

        def three_steps():
            t = mont_mul(BLS12_381_FR, ntt_leaf(BLS12_381_FR, x, ftw[lf]), T_rows)
            return t.reshape(m, n1, B * L_fr).transpose(0, 1).contiguous().reshape(n1, m * B, L_fr)

        if not torch.equal(three_steps(), want):
            raise SystemExit(f"K4 level ({m}, {n1 * B}): leaf + K1 + transpose disagree with the plain version")
        k_ms, three_ms = cuda_ms(kern), cuda_ms(three_steps)
        _, p_ms = cuda_ms_once(lambda: ntt_leaf_plain(BLS12_381_FR, x, ftw[lf], level=(T, B)))
        nbytes = (3 * n + lf * m // 2) * L_fr * 4
        imads = (n1 * B * (m // 2) * lf + n) * mont_imads(L_fr // 2)
        check("ntt_leaf_level", f"K4 ntt_leaf + level ({m}, {n1 * B}, 16), B = {B}", got, want, k_ms, p_ms,
              **(dict(nbytes=nbytes, imads=imads) if first else {}))
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, imads / imad_rate * 1e3
        print(f"K4 level ({m}, {n1 * B}): {k_ms:.4f} ms, bound {max(t_b, t_o):.4f} ms "
              f"({'bytes' if t_b >= t_o else 'operations'}), ms / bound {k_ms / max(t_b, t_o):.2f}; "
              f"leaf + K1 + transpose {three_ms:.4f} ms | {card}", flush=True)
        del got, want, T_rows
        log_rest, B, first = n1_log, B * m, False

    # K7 denom and apply, K6, on 2^16 pairs (PA, A): P == Q, P == -Q and
    # identity rows as above, row 0 P = identity too
    for c in PA:
        c[0] = 0
    x1, y1 = PA
    x2, y2 = A
    fq_b = npts * L_fq * 4
    pl = lambda f, *c: chunked(lambda *cc: f(BLS12_381_FQ, *cc), *c)
    d = kaff.affine_denom(BLS12_381_FQ, x1, y1, x2, y2)
    check("affine_denom", f"K7 affine_denom n={npts}", d, pl(kaff.affine_denom_plain, x1, y1, x2, y2),
          cuda_ms(lambda: kaff.affine_denom(BLS12_381_FQ, x1, y1, x2, y2)),
          cuda_ms(lambda: pl(kaff.affine_denom_plain, x1, y1, x2, y2), iters=1))
    iv = batch_inverse(BLS12_381_FQ, d)

    def apply_check(label, c, **bound):
        """K7 apply against its plain version; its time by device time (a CUDA
        graph of 20 launches: CUDA events around eager calls time the host's
        launch rate at 2^16) beside the events'; 3 products a pair, 4 on
        tangent rows."""
        kern = lambda: kaff.affine_apply(BLS12_381_FQ, *c)
        k_ms = graph_ms(kern)
        ev_ms = cuda_ms(kern)
        rows, tangent = c[0].shape[0], int(kaff._flags(*c[:4])[2].sum())
        check("affine_apply", label, kern(), pl(kaff.affine_apply_plain, *c), k_ms,
              cuda_ms(lambda: pl(kaff.affine_apply_plain, *c), iters=1),
              **(dict(nbytes=7 * rows * L_fq * 4, imads=(3 * rows + tangent) * mont_imads(L_fq // 2))
                 if bound else {}))
        t_b = 7 * rows * L_fq * 4 / HBM_BYTES_PER_S * 1e3
        print(f"K7 affine_apply {rows} pairs ({tangent} tangent): device {k_ms:.4f} ms, CUDA events {ev_ms:.4f} ms; "
              f"bytes bound {t_b:.4f} ms, device ms / bytes bound {k_ms / t_b:.2f} (device: a CUDA graph of 20 "
              f"launches) | {card}", flush=True)

    apply_check(f"K7 affine_apply n={npts}", (x1, y1, x2, y2, iv), bound=True)
    rng_k7 = np.random.default_rng(SEED + 2)  # its own seed: the other phases' inputs stay the parent's
    apply_check(f"K7 affine_apply n=2^{args.log_n}, random rows",
                [torch.as_tensor(random_field(rng_k7, BLS12_381_FQ, n)).to(dev, torch.int32) for _ in range(5)])
    win = 4 if npts >= 4 else 1  # windows, each with its own product-tree root
    cw = [c.reshape(win, npts // win, L_fq) for c in (x1, y1, x2, y2)]
    pp, r1 = partial_products(BLS12_381_FQ, d.reshape(win, npts // win, L_fq))
    r2 = mont_mul(BLS12_381_FQ, r1, r1)
    r3 = mont_mul(BLS12_381_FQ, r2, r1)
    coz_plain = lambda: chunked(lambda *c: kaff.coz_apply_plain(BLS12_381_FQ, *c, r2, r3), *cw, pp, axis=1)
    check("coz_apply", f"K6 coz_apply ({win}, {npts // win}) per-window r", kaff.coz_apply(BLS12_381_FQ, *cw, pp, r2, r3),
          coz_plain(), cuda_ms(lambda: kaff.coz_apply(BLS12_381_FQ, *cw, pp, r2, r3)),
          cuda_ms(coz_plain, iters=1))

    # 4. the main path: CommitPipeline.commit at n = 2^log_n
    t0 = time.perf_counter()
    coeffs_np = random_field(rng, BLS12_381_FR, n)
    _, bases_aff = random_points(nc, rng, n)
    print(f"inputs: {n} coefficients, {n} points k*G in {time.perf_counter() - t0:.1f} s",
          flush=True)
    pipe = CommitPipeline(BLS12_381_G1)
    coeffs = torch.as_tensor(coeffs_np).to(dev, torch.int32)
    bases = pipe.msm.upload_bases(coords_from_u64(nc, bases_aff, 2, dev))

    t0 = time.perf_counter()
    evals, commitment = on_path(kernels, report, ("mont_mul", "inter_twiddle", "point", "point_horner"), "commit",
                                lambda: pipe.commit(coeffs, bases))
    torch.cuda.synchronize()
    print(f"first commit {time.perf_counter() - t0:.2f} s, tables included", flush=True)

    t0 = time.perf_counter()
    want_evals = nfr.ntt(nfr.from_halflimbs(coeffs_np.astype(np.uint64)))
    got_evals = nfr.from_halflimbs(evals.cpu().numpy().astype(np.uint64))
    bad_evals = int((got_evals != want_evals).any(axis=1).sum())
    if evals.shape != (n, 16) or bad_evals:
        raise SystemExit(f"evaluations disagree with the native NTT on {bad_evals} rows")
    got_c = affine_to_u64(nc, pipe.ops.to_affine(commitment))
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

    # K3 on the pair engine's round-0 and round-1 operands, built with the
    # engine's own code, with the keep mask and fused out= rows as the path
    # calls it
    key, data = _bucket_rows(pipe.ops, bases, torch.cat([scalars, scalars.new_zeros((n, 1))], dim=1), wp)
    W = key.shape[0]
    for rnd, op, k in ((0, "add_mixed", 2), (1, "add", 3)):
        s_half = key.shape[1] // 2
        kp = key.reshape(W, s_half, 2)
        keep = kp[..., 0] != kp[..., 1]
        dp = data.reshape(W, s_half, 2, data.shape[-1])
        ins = [*_unfuse(dp[:, :, 0], L_fq, k), *_unfuse(dp[:, :, 1], L_fq, k)]
        out = torch.empty((W, s_half, 3 * L_fq), dtype=torch.int32, device=dev)
        kern = lambda: point_op(BLS12_381_FQ, op, ins, keep=keep, out=out)
        got = tuple(c.clone() for c in kern())
        want, p_ms = cuda_ms_once(lambda: chunked(
            lambda kk, *c: point_op_plain(BLS12_381_FQ, op, list(c), kk), keep, *ins,
            axis=1, rows=max(1, CHUNK // W)))
        # the rows that add: keys equal and both operands finite
        if k == 2:
            fin = [((c[0] != 0) | (c[1] != 0)).any(-1) for c in (ins[:2], ins[2:])]
        else:
            fin = [(ins[2] != 0).any(-1), (ins[5] != 0).any(-1)]
        n_add = int((~keep & fin[0] & fin[1]).sum())
        rows = W * s_half
        nbytes = rows * (k + 3) * L_fq * 4 + int((~keep).sum()) * k * L_fq * 4 + rows
        imads = n_add * (11 if k == 2 else 16) * mont_imads(L_fq // 2)
        k_ms = cuda_ms(kern)
        check("point", f"K3 {op} round {rnd} ({W}, {s_half}, {L_fq}), {n_add} adding rows, keep + out=",
              got, want, k_ms, p_ms, **(dict(nbytes=nbytes, imads=imads) if rnd == 1 else {}))
        t_b, t_o = nbytes / HBM_BYTES_PER_S * 1e3, imads / imad_rate * 1e3
        print(f"K3 {op} round {rnd}: {k_ms:.4f} ms, bound {max(t_b, t_o):.4f} ms "
              f"({'bytes' if t_b >= t_o else 'operations'}), ms / bound {k_ms / max(t_b, t_o):.2f} | {card}",
              flush=True)
        del want, got
        if rnd == 0:
            key, data, _, _ = _pair_round(pipe.ops, key, data, affine=True,
                                          spill_cap=min(s_half, (1 << (wp - 1)) + 2))
    del key, data, kp, keep, dp, ins, out

    # 4b. the fused NTT (config ntt_impl="fused") on phase 4's coefficients
    cfg = get_config()
    default_leaf = cfg.ntt_leaf_log
    cfg.ntt_impl = "fused"
    fused_ms = {}
    for leaf in sorted({5, 8, default_leaf}):
        cfg.ntt_leaf_log = leaf
        fk = FftKernel(BLS12_381_FR)
        t0 = time.perf_counter()
        y = fk.radix_fft(coeffs)
        torch.cuda.synchronize()
        t_first = time.perf_counter() - t0
        if not torch.equal(y, evals):
            raise SystemExit(f"fused NTT (leaf {leaf}) disagrees with the digit NTT")
        fused_ms[leaf] = timeit(lambda: fk.radix_fft(coeffs), iters=3) * 1e3
        print(f"fused NTT 2^{args.log_n} leaf {leaf} (plan {get_fused_domain(BLS12_381_FR, args.log_n).plan}): "
              f"== digit evaluations; {fused_ms[leaf]:.2f} ms mean of 3 (first call {t_first:.1f} s, "
              f"tables included) vs digit {stage['ntt']:.2f} ms | {card}", flush=True)
    cfg.ntt_leaf_log = default_leaf
    fk = FftKernel(BLS12_381_FR)
    y = on_path(kernels, report, ("ntt_leaf", "ntt_leaf_level"), "fused NTT", lambda: fk.radix_fft(coeffs))
    got = kernels.launch_counters()
    levels = len(get_fused_domain(BLS12_381_FR, args.log_n).plan) - 1
    if (got["ntt_leaf_level"], got["ntt_leaf"], got["mont_mul"]) != (levels, 1, 0):
        raise SystemExit(f"fused NTT: expected {levels} K4 launches with the level epilogue, one "
                         f"without and no K1; got {got}")
    back = fk.radix_fft(y, inverse=True)
    if not (torch.equal(y, evals) and torch.equal(back, coeffs)):
        raise SystemExit("fused NTT: forward != digit evaluations or inverse != coefficients")
    print(f"fused NTT leaf {default_leaf}: forward == digit evaluations, inverse == coefficients", flush=True)
    cfg.ntt_impl = "digit"

    # radix_fft_many on (2^11, 2^9, 16): K5's full-width path
    batch = coeffs.reshape(-1, 512, L_fr)
    many = on_path(kernels, report, ("pease_stage",), "radix_fft_many",
                   lambda: pipe.fft.radix_fft_many(batch))
    report.launches["pease_stages"] = report.launches["pease_stage"]
    kernels.reset_launch_counters()
    back = pipe.fft.radix_fft_many(many, inverse=True)
    got = kernels.launch_counters()
    if (report.launches["pease_stage"], got["pease_stage"], got["mont_mul"]) != (1, 1, 1):
        raise SystemExit(f"radix_fft_many: expected one K5 launch forward and one K5 + one K1 "
                         f"inverse; got {report.launches['pease_stage']} and {got}")
    rows = sorted({0, 1, batch.shape[0] // 2, batch.shape[0] - 1})
    for r in rows:
        want = nfr.ntt(nfr.from_halflimbs(batch[r].cpu().numpy().astype(np.uint64)))
        if not np.array_equal(nfr.from_halflimbs(many[r].cpu().numpy().astype(np.uint64)), want):
            raise SystemExit(f"radix_fft_many row {r} disagrees with the native NTT")
    if not torch.equal(back, batch):
        raise SystemExit("radix_fft_many: inverse does not give the inputs back")
    many_ms = timeit(lambda: pipe.fft.radix_fft_many(batch), iters=3) * 1e3
    print(f"radix_fft_many {tuple(batch.shape)}: rows {rows} == native NTT, inverse == inputs; "
          f"{many_ms:.2f} ms mean of 3 | {card}", flush=True)

    # 4c. the co-Z MSM on phase 4's bases and scalars
    msm = pipe.msm
    cz = on_path(kernels, report, ("coz_apply", "affine_denom"), "co-Z MSM",
                 lambda: msm.multiexp(bases, scalars, method="coz"))
    coz_launches = {k: v for k, v in kernels.launch_counters().items() if v}
    if not np.array_equal(affine_to_u64(nc, pipe.ops.to_affine(cz)), want_c):
        raise SystemExit("co-Z MSM disagrees with the commitment")
    torch.cuda.reset_peak_memory_stats()
    coz_ms = timeit(lambda: msm.multiexp(bases, scalars, method="coz"), iters=3) * 1e3
    coz_peak = torch.cuda.max_memory_allocated()
    pair_ms = timeit(lambda: msm.multiexp(bases, scalars, method="pair"), iters=3) * 1e3
    print(f"co-Z MSM 2^{args.log_n}: == commitment; {coz_ms:.1f} ms mean of 3 vs pair {pair_ms:.1f} ms; "
          f"peak {coz_peak / 2**30:.2f} GiB; launches {coz_launches} | {card}", flush=True)

    # K7 denom and K6 on the co-Z MSM's first-round operands: (W, s0, L)
    # column slices of the fused (W, s0, 2L) pair rows, r^2 and r^3 per window
    w = tuned_window(BLS12_381_G1.name, "coz", n) or default_window_size_coz(n)  # the co-Z MSM's
    sizes = _plan_sizes(n, 1 << (w - 1))
    key, data = _bucket_rows(msm.ops, bases, torch.cat([scalars, scalars.new_zeros((n, 1))], dim=1), w)
    _, ra, rb = _pair_up(key, data, sizes[0] if sizes else n)
    del key, data
    W, s0 = ra.shape[:2]
    c1x, c1y, c2x, c2y = ra[..., :L_fq], ra[..., L_fq:], rb[..., :L_fq], rb[..., L_fq:]
    rows = max(1, CHUNK // W)
    iz1, iz2 = ~(ra != 0).any(-1), ~(rb != 0).any(-1)
    n_both, n_one = int((~iz1 & ~iz2).sum()), int((iz1 ^ iz2).sum())
    del iz1, iz2
    fq_b = W * s0 * L_fq * 4
    d, p_ms = cuda_ms_once(lambda: chunked(lambda *c: kaff.affine_denom_plain(BLS12_381_FQ, *c),
                                           c1x, c1y, c2x, c2y, axis=1, rows=rows))
    check("affine_denom", f"K7 affine_denom co-Z round 1 ({W}, {s0}, {L_fq})",
          kaff.affine_denom(BLS12_381_FQ, c1x, c1y, c2x, c2y), d,
          cuda_ms(lambda: kaff.affine_denom(BLS12_381_FQ, c1x, c1y, c2x, c2y)), p_ms,
          nbytes=5 * fq_b, imads=0)
    pp, r1 = partial_products(BLS12_381_FQ, d)
    r2 = mont_mul(BLS12_381_FQ, r1, r1)
    r3 = mont_mul(BLS12_381_FQ, r2, r1)
    del d, r1
    want, p_ms = cuda_ms_once(lambda: chunked(lambda *c: kaff.coz_apply_plain(BLS12_381_FQ, *c, r2, r3),
                                              c1x, c1y, c2x, c2y, pp, axis=1, rows=rows))
    # 9 products where both operands are finite, 2 (the rescaled copy)
    # where one is the identity, none where both are
    check("coz_apply", f"K6 coz_apply co-Z round 1 ({W}, {s0}, {L_fq}), {n_both} pairs, {n_one} singles",
          kaff.coz_apply(BLS12_381_FQ, c1x, c1y, c2x, c2y, pp, r2, r3), want,
          cuda_ms(lambda: kaff.coz_apply(BLS12_381_FQ, c1x, c1y, c2x, c2y, pp, r2, r3)), p_ms,
          nbytes=7 * fq_b, imads=(9 * n_both + 2 * n_one) * mont_imads(L_fq // 2))
    del ra, rb, c1x, c1y, c2x, c2y, pp, r2, r3, want
    print(f"co-Z rounds: {len(sizes)} shrinking ({', '.join(map(str, sizes))} rows a window), then "
          f"{max(1, math.ceil(math.log2(sizes[-1]))) if sizes else 0} at {sizes[-1] if sizes else n}",
          flush=True)

    # 4d. affine_add_batch (K7 apply) on the phase-3 pairs vs the Jacobian add
    ops = pipe.ops
    s3 = on_path(kernels, report, ("affine_apply",), "affine_add_batch",
                 lambda: affine_add_batch(BLS12_381_FQ, (x1, y1), (x2, y2)))
    want3 = ops.to_affine(ops.add_mixed(ops.to_jacobian((x1, y1)), (x2, y2)))
    if not all(torch.equal(g, w) for g, w in zip(s3, want3)):
        raise SystemExit("affine_add_batch disagrees with the Jacobian mixed add")
    print(f"affine_add_batch n={npts}: == Jacobian add_mixed + to_affine", flush=True)

    # device time of each hand kernel over one call of each path
    def fused_fft():
        cfg.ntt_impl = "fused"
        try:
            return fk.radix_fft(coeffs)
        finally:
            cfg.ntt_impl = "digit"

    for label, fn, alone in (("commit", lambda: pipe.commit(coeffs, bases), False),
                             ("co-Z MSM", lambda: msm.multiexp(bases, scalars, method="coz"), False),
                             ("fused NTT", fused_fft, True),
                             ("radix_fft_many", lambda: pipe.fft.radix_fft_many(batch), True),
                             ("affine_add_batch", lambda: affine_add_batch(BLS12_381_FQ, (x1, y1), (x2, y2)),
                              False)):
        split, busy, others = traced(fn, label)
        parts = ", ".join(f"{k} {v[0]:.4f} ms in {v[1]}" for k, v in sorted(split.items(), key=lambda kv: -kv[1][0]))
        print(f"profile {label}: device busy {busy:.4f} ms; hand kernels {parts} | {card}", flush=True)
        print(f"profile {label}: largest other device ops: "
              + "; ".join(f"{name[:60]} {ms:.4f} ms in {cnt}" for name, ms, cnt in others), flush=True)
        if alone and others:
            raise SystemExit(f"profile {label}: device ops besides the hand kernels: {others}")

    # 4e. the AMT batch: multiple_multiexp on 2^c-point chunks
    t_amt = time.perf_counter()
    log_chunk = min(10, args.log_n // 2)
    chunk = 1 << log_chunk
    c_a, c_b = n >> log_chunk, 4 * (n >> log_chunk)
    wb = tuned_window(BLS12_381_G1.name, "pair", chunk) or default_window_size_pair(chunk)  # the batch's
    nwin_b, half_b = -(-SCALAR_BITS // wb), 1 << (wb - 1)
    scal_a_np = random_field(rng, BLS12_381_FR, n)  # plain Fr integers, rows 0-2: 0, 1, r - 1
    scal_a = torch.as_tensor(scal_a_np).to(dev, torch.int32)

    def k3_per_slab(slab: int) -> int:
        """K3 launches of one slab: the pair rounds over its rows, the
        finish, the prefix scan and the tree of the tails, one Horner."""
        rounds = (slab * chunk).bit_length() - 1
        return rounds + max(1, math.ceil(math.log2(rounds + 2))) + 2 * (wb - 1) + 1

    def native_chunks(aff, scal_np, chunks, got, label):
        """Chunks of a batch against the native C++ Pippenger, compared as
        affine points (native to_affine on both sides)."""
        got_u64 = np.concatenate([nc.fq.from_halflimbs(c[chunks].cpu().numpy().astype(np.uint64)) for c in got],
                                 axis=1)
        s_u64 = nfr.from_halflimbs(scal_np.astype(np.uint64))
        want = np.stack([nc.msm(aff[(c * chunk) % n : (c * chunk) % n + chunk], s_u64[c * chunk : (c + 1) * chunk])
                         for c in chunks])
        bad = int((nc.to_affine(got_u64) != nc.to_affine(want)).any(axis=1).sum())
        if bad:
            raise SystemExit(f"{label}: {bad} of {len(chunks)} chunks disagree with the native Pippenger MSM")

    slab_a = batch_slab(BLS12_381_G1, "pair", chunk, wb, dev)
    slab_a = min(slab_a, c_a)
    run_a = lambda: msm.multiple_multiexp(bases, scal_a, c_a)
    slabs_a = -(-c_a // slab_a)
    out_a = on_path(kernels, report, ("point_horner",), f"AMT batch A (2^{log_chunk} x {c_a})", run_a,
                    rows={"point_horner": "point_horner_batch"})
    # the path's K3 launches of every entry (the Horner's among them), from
    # the counters as the run left them
    k3_a, k3_want = kernels.launch_counters()["point"], slabs_a * k3_per_slab(slab_a)
    if k3_a != k3_want or report.launches["point_horner_batch"] != slabs_a:
        raise SystemExit(f"AMT batch A: {k3_a} K3 launches, {report.launches['point_horner_batch']} of them the "
                         f"Horner's; the rounds predict {k3_want}, one Horner a slab ({slabs_a})")
    t0 = time.perf_counter()
    native_chunks(bases_aff, scal_a_np, list(range(c_a)), out_a, "AMT batch A")
    t_native_a = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    ms_a, runs_a = host_ms(run_a)
    peak_a = torch.cuda.max_memory_allocated()
    print(f"AMT batch A 2^{log_chunk} x {c_a} (w = {wb}, {nwin_b} windows): all {c_a} chunks == native Pippenger "
          f"({t_native_a:.1f} s of host referee); {ms_a:.2f} ms per batch mean of 3 "
          f"({', '.join(f'{t:.2f}' for t in runs_a)}), {n / ms_a * 1e3:.0f} points/s; slab {slab_a} chunks, "
          f"{slabs_a} slabs; peak {peak_a / 2**30:.2f} GiB; K3 launches of every entry {k3_a} (rounds predict "
          f"{k3_want}), of the Horner entry {report.launches['point_horner_batch']} | {card}", flush=True)

    # shape B: the reference's 2^10 x 2^12, phase 4's points tiled four times
    bases_b = tuple(t.repeat(4, 1) for t in bases)
    scal_b_np = random_field(rng, BLS12_381_FR, 4 * n)
    scal_b = torch.as_tensor(scal_b_np).to(dev, torch.int32)
    slab_b = min(batch_slab(BLS12_381_G1, "pair", chunk, wb, dev), c_b)
    run_b = lambda: msm.multiple_multiexp(bases_b, scal_b, c_b)
    out_b = run_b()
    sample = [0, *sorted(rng.choice(np.arange(1, c_b - 1), size=min(62, c_b - 2), replace=False).tolist()), c_b - 1]
    native_chunks(bases_aff, scal_b_np, sample, out_b, "AMT batch B")
    torch.cuda.reset_peak_memory_stats()
    ms_b, runs_b = host_ms(run_b)
    peak_b = torch.cuda.max_memory_allocated()
    print(f"AMT batch B 2^{log_chunk} x {c_b} (bases tiled 4x): {len(sample)} sampled chunks (first and last "
          f"included) == native Pippenger; {ms_b:.2f} ms per batch mean of 3 "
          f"({', '.join(f'{t:.2f}' for t in runs_b)}), {4 * n / ms_b * 1e3:.0f} points/s; slab {slab_b} chunks, "
          f"{-(-c_b // slab_b)} slabs; peak {peak_b / 2**30:.2f} GiB | {card}", flush=True)
    del bases_b, scal_b, out_b

    # the scan engine: a batch of 2^6 chunks and one 2^16 MSM, against the
    # pair engine's results
    ops = pipe.ops
    c_s = min(64, c_a)
    same = lambda p, q: all(torch.equal(x, y) for x, y in zip(ops.to_affine(p), ops.to_affine(q)))
    scan_b = msm.multiple_multiexp(tuple(t[: c_s * chunk] for t in bases), scal_a[: c_s * chunk], c_s, method="scan")
    if not same(scan_b, tuple(c[:c_s] for c in out_a)):
        raise SystemExit("scan batch disagrees with the pair batch")
    n_s = min(n, 1 << 16)
    scan_1 = msm.multiexp(tuple(t[:n_s] for t in bases), scal_a[:n_s], method="scan")
    if not same(scan_1, msm.multiexp(tuple(t[:n_s] for t in bases), scal_a[:n_s], method="pair")):
        raise SystemExit("scan MSM disagrees with the pair MSM")
    print(f"scan engine: batch 2^{log_chunk} x {c_s} == pair batch; MSM 2^{n_s.bit_length() - 1} == pair MSM",
          flush=True)

    # K3's batched Horner at the path's (W, C) shape, on the sums of shape
    # A's first slab, against its plain version
    part = bucket_tail(ops, msm_pair_buckets(
        ops, tuple(t[: slab_a * chunk].reshape(slab_a, chunk, L_fq) for t in bases),
        torch.cat([scal_a[: slab_a * chunk], scal_a.new_zeros((slab_a * chunk, 1))], dim=1).reshape(slab_a, chunk, -1),
        window_size=wb), half_b)
    S = _unfuse(part, L_fq, 3)
    want, p_ms = cuda_ms_once(lambda: horner_plain(BLS12_381_FQ, S, wb))
    hb_ms = cuda_ms(lambda: horner(BLS12_381_FQ, S, wb))
    levels, prods = horner_work(S, wb)
    check("point_horner_batch", f"K3 horner batched ({nwin_b}, {slab_a}, {L_fq}) w={wb}",
          horner(BLS12_381_FQ, S, wb), want, hb_ms, p_ms,
          nbytes=(nwin_b + 1) * slab_a * 3 * L_fq * 4, imads=prods * mont_imads(L_fq // 2),
          serial_ms=levels * lat[L_fq // 2])
    hb_bound = report.rows["point_horner_batch"]["bound_ms"]
    print(f"K3 horner batched: {hb_ms:.4f} ms, bound {hb_bound:.4f} ms (operations in series: the longest of "
          f"{slab_a} chains side by side, {levels} product levels x {lat[L_fq // 2] * 1e3:.4f} us, one product's "
          f"latency; all chains' {prods} products at the IMAD rate "
          f"{prods * mont_imads(L_fq // 2) / imad_rate * 1e3:.4f} ms), ms / bound {hb_ms / hb_bound:.2f} | {card}",
          flush=True)
    del part, S, want

    split, busy, others = traced(run_a, "AMT batch A")
    k3_ms = sum(v[0] for k, v in split.items() if k.startswith("K3"))
    parts = ", ".join(f"{k} {v[0]:.4f} ms in {v[1]}" for k, v in sorted(split.items(), key=lambda kv: -kv[1][0]))
    print(f"profile AMT batch A: device busy {busy:.4f} ms, K3 {k3_ms:.4f} ms; hand kernels {parts} | {card}",
          flush=True)
    print("profile AMT batch A: largest other device ops: "
          + "; ".join(f"{name[:60]} {ms:.4f} ms in {cnt}" for name, ms, cnt in others), flush=True)
    print(f"phase 4e: {time.perf_counter() - t_amt:.1f} s", flush=True)

    # 4f. the EC-group FFT, K3's chain and stage entries, the coefficient-basis
    # and sparse commits
    t_ec = time.perf_counter()
    nc_bn = native_curve(BN254_G1)
    lg_ec = min(11, args.log_n)  # the reference's largest bench degree
    n_ec = 1 << lg_ec

    def ec_fft_sizes(curve, ncv, log_ns):
        """The forward EC-FFT at each 2^lg, every output against the native
        EC-FFT; the 2^lg_ec run is the path's, its launches counted.
        Returns the kernel, the last input and output."""
        kern = EcFftKernel(curve)
        for lg in log_ns:
            m = 1 << lg
            jac, _ = random_points(ncv, rng, m)
            P = coords_from_u64(ncv, jac, 3, dev)
            run = lambda: kern.radix_ec_fft(P)
            out = on_path(kernels, report if curve is BN254_G1 else None, ("ec_fft_stage",),
                          f"EC-FFT {curve.name} 2^{lg}", run) if lg == lg_ec else run()
            if lg == lg_ec and kernels.launch_counters()["ec_fft_stage"] != lg:
                raise SystemExit(f"EC-FFT 2^{lg}: {kernels.launch_counters()['ec_fft_stage']} stage launches, "
                                 f"not one a stage ({lg})")
            t0 = time.perf_counter()
            bad = int((native_affine(ncv, out) != ncv.to_affine(ncv.ec_fft(jac))).any(axis=1).sum())
            t_ref = time.perf_counter() - t0
            if bad:
                raise SystemExit(f"EC-FFT {curve.name} 2^{lg}: {bad} of {m} outputs disagree with the native EC-FFT")
            ms, runs = host_ms(run)
            print(f"EC-FFT {curve.name} 2^{lg}: all {m} outputs == native EC-FFT ({t_ref:.1f} s of host referee); "
                  f"{ms:.3f} ms mean of 3 ({', '.join(f'{t:.3f}' for t in runs)}), {m / ms * 1e3:.0f} points/s "
                  f"| {card}", flush=True)
        return kern, P, out

    kern_bn, P_bn, out_bn = ec_fft_sizes(BN254_G1, nc_bn, range(min(4, lg_ec), lg_ec + 1))
    kern_bls, P_bls, _ = ec_fft_sizes(BLS12_381_G1, nc, [lg_ec])
    back = on_path(kernels, None, ("ec_fft_stage", "point_scalar_mul"), f"EC-FFT inverse 2^{lg_ec}",
                   lambda: kern_bn.radix_ec_fft(out_bn, inverse=True))
    inv_counts = kernels.launch_counters()
    if (inv_counts["ec_fft_stage"], inv_counts["point_scalar_mul"]) != (lg_ec, 1):
        raise SystemExit(f"EC-FFT inverse 2^{lg_ec}: launches {inv_counts}; expected {lg_ec} stages and 1 chain")
    report.launches["point_scalar_mul"] = inv_counts["point_scalar_mul"]
    if not np.array_equal(native_affine(nc_bn, back), native_affine(nc_bn, P_bn)):
        raise SystemExit(f"EC-FFT inverse 2^{lg_ec} does not give its input back")
    inv_ms, inv_runs = host_ms(lambda: kern_bn.radix_ec_fft(out_bn, inverse=True))
    print(f"EC-FFT {BN254_G1.name} inverse 2^{lg_ec}: == input; {inv_ms:.3f} ms mean of 3 "
          f"({', '.join(f'{t:.3f}' for t in inv_runs)}) | {card}", flush=True)

    # a batch of 16 transforms of 2^lg_ec against 16 single calls
    many_in = [coords_from_u64(nc_bn, random_points(nc_bn, rng, n_ec)[0], 3, dev) for _ in range(16)]
    many_out = kern_bn.radix_ec_fft_many(many_in)
    singles = [kern_bn.radix_ec_fft(P) for P in many_in]
    if not all(all(torch.equal(a, b) for a, b in zip(g, w)) for g, w in zip(many_out, singles)):
        raise SystemExit("radix_ec_fft_many disagrees with single calls")
    many_ms, many_runs = host_ms(lambda: kern_bn.radix_ec_fft_many(many_in))
    single_ms, _ = host_ms(lambda: [kern_bn.radix_ec_fft(P) for P in many_in])
    print(f"radix_ec_fft_many 16 x 2^{lg_ec} BN254: each == its single call; {many_ms:.3f} ms mean of 3 "
          f"({', '.join(f'{t:.3f}' for t in many_runs)}), {16 * n_ec / many_ms * 1e3:.0f} points/s; 16 single "
          f"calls {single_ms:.3f} ms | {card}", flush=True)
    del singles  # the batch and its output stay for phase 4j

    def chain_work(k):
        """(point ops, field products) of the chains on the plain scalars k
        (n, 16) (``chain_steps``), and the longest chain's point ops."""
        dbls, adds = chain_steps(k)
        prods = FQ_PRODUCTS["double"] * sum(dbls) + FQ_PRODUCTS["add"] * sum(adds)
        return sum(dbls) + sum(adds), prods, max(d + a for d, a in zip(dbls, adds))

    def op_latency(spec, P):
        """Device ms of one point op in series: a one-point chain over 2^256 - 1
        (255 doubles and 255 adds), one tile of lanes."""
        ones = torch.full((1, 16), 0xFFFF, dtype=torch.int32, device=dev)
        return cuda_ms(lambda: point_scalar_mul(spec, [c[:1] for c in P], ones)) / 510

    L_bn = BN254_FQ.n_limbs
    tile_bn, tile_fq = chain_tile(BN254_FQ), chain_tile(BLS12_381_FQ)
    lat_bn = op_latency(BN254_FQ, P_bn)
    print(f"K3 chain entries (csrc/chain.cu): a field element on a tile of {tile_bn} lanes at 8 words, "
          f"{tile_fq} at 12 words; one point op in series {lat_bn * 1e3:.3f} us at 8 words (a one-point chain "
          f"over 2^256 - 1, 510 ops) | {card}", flush=True)

    # K3's chain entry at the path's own launch: the BN254 2^lg_ec inverse's
    # scaling, its bit-reversed stage output times one scalar n^-1 (row
    # stride 0); the kernel's output is the inverse's result
    tw_inv, n_inv, rev_inv = kern_bn._domain_tensors(lg_ec, True)
    Y = tuple(out_bn)
    for st in range(lg_ec):
        Y = ec_fft_stage(BN254_FQ, Y, tw_inv, st)
    Y = tuple(c.index_select(-2, rev_inv) for c in Y)
    got = point_scalar_mul(BN254_FQ, Y, n_inv)
    if not all(torch.equal(a, b) for a, b in zip(got, back)):
        raise SystemExit("K3 scalar_mul chain: the inverse's scaling, launched alone, is not the inverse's result")
    want, p_ms = cuda_ms_once(lambda: scalar_mul_plain(BN254_FQ, Y, n_inv))
    c_ms = cuda_ms(lambda: point_scalar_mul(BN254_FQ, Y, n_inv))
    ops_n, prods, longest = chain_work(n_inv.expand(n_ec, -1))
    check("point_scalar_mul", f"K3 scalar_mul chain ({n_ec}, {L_bn}), the inverse's n^-1 (stride 0), "
          f"{ops_n} point ops", got, want, c_ms, p_ms,
          nbytes=(n_ec * 6 * L_bn + 16) * 4, imads=prods * mont_imads(L_bn // 2))
    cb = report.rows["point_scalar_mul"]["bound_ms"]
    print(f"K3 scalar_mul chain: {c_ms:.4f} ms, bound {cb:.4f} ms (operations), ms / bound {c_ms / cb:.1f}; "
          f"serial bound {longest * lat_bn:.4f} ms (one chain, {longest} point ops x {lat_bn * 1e3:.2f} us, "
          f"a one-point chain's), ms / serial {c_ms / (longest * lat_bn):.2f} | {card}", flush=True)
    del want, got, Y

    # the chain entry at 12 words: n_ec / 2 (1024) BLS12-381 points of the
    # transform's input, random plain Fr scalars (rows 0-2: 0, 1, r - 1)
    h_ec = n_ec // 2
    P1k = [c[:h_ec] for c in P_bls]
    k1k = torch.as_tensor(random_field(rng, BLS12_381_FR, h_ec)).to(dev, torch.int32)
    want, p_ms = cuda_ms_once(lambda: scalar_mul_plain(BLS12_381_FQ, P1k, k1k))
    c_ms = cuda_ms(lambda: point_scalar_mul(BLS12_381_FQ, P1k, k1k))
    ops_n, _, longest = chain_work(k1k)
    check("point_scalar_mul", f"K3 scalar_mul chain ({h_ec}, {L_fq}), random scalars, {ops_n} point ops",
          point_scalar_mul(BLS12_381_FQ, P1k, k1k), want, c_ms, p_ms)
    lat_fq = op_latency(BLS12_381_FQ, P1k)
    print(f"K3 chain entries: one point op in series {lat_fq * 1e3:.3f} us at 12 words | {card}", flush=True)
    print(f"K3 scalar_mul chain ({h_ec}, {L_fq}): serial bound {longest * lat_fq:.4f} ms (the longest chain, "
          f"{longest} point ops x {lat_fq * 1e3:.2f} us, a one-point chain's), ms / serial "
          f"{c_ms / (longest * lat_fq):.2f} | {card}", flush=True)
    del want

    # K3's EC-FFT stage entry: stage 0 of the BN254 2^lg_ec transform (1024
    # butterflies, scalars w^i)
    tw_bn = kern_bn._domain_tensors(lg_ec, False)[0]
    want, p_ms = cuda_ms_once(lambda: ec_fft_stage_plain(BN254_FQ, P_bn, tw_bn, 0))
    s_ms = cuda_ms(lambda: ec_fft_stage(BN254_FQ, P_bn, tw_bn, 0))
    ops_n, prods, longest = chain_work(tw_bn)
    check("ec_fft_stage", f"K3 ec_fft_stage stage 0 ({n_ec}, {L_bn}), {h_ec} butterflies, {ops_n} chain point ops",
          ec_fft_stage(BN254_FQ, P_bn, tw_bn, 0), want, s_ms, p_ms,
          nbytes=h_ec * (12 * L_bn + 16) * 4, imads=(prods + h_ec * 32) * mont_imads(L_bn // 2))
    sb = report.rows["ec_fft_stage"]["bound_ms"]
    serial = (longest + 2) * lat_bn
    print(f"K3 ec_fft_stage: {s_ms:.4f} ms, bound {sb:.4f} ms (operations), ms / bound {s_ms / sb:.1f}; serial "
          f"bound {serial:.4f} ms (an add, a sub and the longest chain, {longest} point ops, x "
          f"{lat_bn * 1e3:.2f} us, a one-point chain's), ms / serial {s_ms / serial:.2f}; a 2^{lg_ec} transform is "
          f"{lg_ec} such stages in series | {card}", flush=True)
    del want

    # the BN254 transform's stages one by one (CUDA events); beside stage 0,
    # the stages on both sides of log2(32 / T) (below it the tiles of a warp
    # hold different scalars, from it on one) and the last held against
    # their plain versions
    uniform_bn = (32 // tile_bn).bit_length() - 1
    held = sorted({uniform_bn - 1, uniform_bn, lg_ec - 1} & set(range(1, lg_ec)))
    Y, stage_bn = tuple(P_bn), []
    for st in range(lg_ec):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        Z = ec_fft_stage(BN254_FQ, Y, tw_bn, st)
        ev[1].record()
        torch.cuda.synchronize()
        stage_bn.append(ev[0].elapsed_time(ev[1]))
        if st in held:
            want, p_ms = cuda_ms_once(lambda: ec_fft_stage_plain(BN254_FQ, Y, tw_bn, st))
            check("ec_fft_stage", f"K3 ec_fft_stage stage {st} ({n_ec}, {L_bn}), {h_ec} butterflies", Z, want,
                  stage_bn[-1], p_ms)
            del want
        Y = Z
    if not all(torch.equal(a.index_select(-2, kern_bn._domain_tensors(lg_ec, False)[2]), b)
               for a, b in zip(Y, out_bn)):
        raise SystemExit(f"EC-FFT BN254 2^{lg_ec}: its stages one by one disagree with the transform")
    print(f"EC-FFT BN254 2^{lg_ec} stages 0..{lg_ec - 1}: {', '.join(f'{t:.3f}' for t in stage_bn)} ms "
          f"(sum {sum(stage_bn):.3f}; s < {uniform_bn}: the tiles of a warp hold different scalars; stages "
          f"{[0] + held} == plain) | {card}", flush=True)

    # the BLS12-381 transform's stages one by one (CUDA events), stage 0
    # held against its plain version, then its profile in a fresh process
    (tw_bls, _, rev_bls), Y, stage_ms = kern_bls._domain_tensors(lg_ec, False), tuple(P_bls), []
    for st in range(lg_ec):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(2)]
        ev[0].record()
        Z = ec_fft_stage(BLS12_381_FQ, Y, tw_bls, st)
        ev[1].record()
        torch.cuda.synchronize()
        stage_ms.append(ev[0].elapsed_time(ev[1]))
        if st == 0:
            want, p_ms = cuda_ms_once(lambda: ec_fft_stage_plain(BLS12_381_FQ, Y, tw_bls, 0))
            check("ec_fft_stage", f"K3 ec_fft_stage stage 0 ({n_ec}, {L_fq}), {h_ec} butterflies", Z, want,
                  stage_ms[0], p_ms)
            del want
        Y = Z
    if not all(torch.equal(a.index_select(-2, rev_bls), b) for a, b in zip(Y, kern_bls.radix_ec_fft(P_bls))):
        raise SystemExit(f"EC-FFT BLS12-381 2^{lg_ec}: its stages one by one disagree with the transform")
    print(f"EC-FFT BLS12-381 2^{lg_ec} stages 0..{lg_ec - 1}: {', '.join(f'{t:.3f}' for t in stage_ms)} ms "
          f"(sum {sum(stage_ms):.3f}; s < {(32 // tile_fq).bit_length() - 1}: the tiles of a warp hold different "
          f"scalars) | {card}", flush=True)
    res = subprocess.run([sys.executable, os.path.abspath(__file__), "--profile-ec-fft", str(lg_ec)],
                         capture_output=True, text=True, timeout=300)
    if res.returncode:
        raise SystemExit(f"profile EC-FFT BLS12-381 2^{lg_ec}: exit {res.returncode}\n{res.stderr[-2000:]}")
    prof = json.loads(res.stdout.strip().splitlines()[-1])
    split, busy = prof["split"], prof["busy"]
    parts = ", ".join(f"{k} {v[0]:.4f} ms in {v[1]}" for k, v in sorted(split.items(), key=lambda kv: -kv[1][0]))
    k3_ms = sum(v[0] for k, v in split.items() if k.startswith("K3"))
    print(f"profile EC-FFT BLS12-381 2^{lg_ec} (a fresh process, {prof['attempts']} trace(s)): device busy "
          f"{busy:.4f} ms, K3 {k3_ms:.4f} ms ({k3_ms / busy:.1%}), all {lg_ec} stage launches traced; hand kernels "
          f"{parts}; other device ops: " + "; ".join(f"{name[:60]} {ms:.4f} ms in {cnt}" for name, ms, cnt in
                                                     prof["others"]) + f" | {card}", flush=True)

    # the coefficient-basis and sparse commits on phase 4's bases and
    # coefficients, against the native Pippenger over the same terms
    plain_scal = nfr.from_mont(nfr.from_halflimbs(coeffs_np.astype(np.uint64)))
    dens = DensityTracker()
    for i, bit in enumerate(rng.random(n) < 0.5):
        dens.add_element()
        if bit:
            dens.inc(i)
    idx = np.nonzero(dens.generate_mask(n))[0]
    for label, run, aff, scal in (
        ("commit_coefficient_basis", lambda: pipe.commit_coefficient_basis(coeffs, bases), bases_aff, plain_scal),
        ("commit_sparse", lambda: pipe.commit_sparse(coeffs, bases, dens), bases_aff[idx], plain_scal[idx]),
    ):
        got = on_path(kernels, None, ("mont_mul", "point"), f"{label} 2^{args.log_n}", run)
        t0 = time.perf_counter()
        if not np.array_equal(affine_to_u64(nc, pipe.ops.to_affine(got)), nc.to_affine(nc.msm(aff, scal)[None, :])):
            raise SystemExit(f"{label} disagrees with the native Pippenger MSM")
        t_ref = time.perf_counter() - t0
        ms, runs = host_ms(run)
        print(f"{label} 2^{args.log_n} ({len(scal)} terms): == native Pippenger ({t_ref:.1f} s of host referee); "
              f"{ms:.2f} ms mean of 3 ({', '.join(f'{t:.2f}' for t in runs)}) | {card}", flush=True)
    # the sparse commit's parts: the compaction (host mask, gathers) and the
    # MSM of the compacted terms
    pscal = pipe.fr.from_mont(coeffs)
    compact_ms, _ = host_ms(lambda: compact_by_density(dens, bases, pscal))
    cb, cs_ = compact_by_density(dens, bases, pscal)
    msm_ms, _ = host_ms(lambda: msm.multiexp(cb, cs_))
    print(f"commit_sparse parts: compaction {compact_ms:.2f} ms, MSM of the {cs_.shape[0]} terms {msm_ms:.2f} ms "
          f"| {card}", flush=True)
    del cb, cs_, pscal
    print(f"phase 4f: {time.perf_counter() - t_ec:.1f} s", flush=True)

    # 4g. G2: the MSM (the main path of G2), the batch, scalar multiplication,
    # the EC-FFT, a commit and K3's Fq2 instances
    phase_g2(args.log_n, dev, report, check, card, lat, imad_rate)

    # 4h. the digit NTT at 2^22 .. 2^26: both routes at 2^26, BN254 chunked,
    # the batch, K2's int8 entry at the final pass's shape
    phase_ntt_large(dev, report, check, card)

    # 4i. the bucket lattice: unsigned and signed G1 MSMs, multiexp_1bit, an
    # unsigned G2 MSM, and the window the table gives the commit
    phase_lattice(dev, card, nc, bases_aff, sum(commit_ms) / 3, args.log_n, report, lat)

    # 4j. the multi-device layer at world size 1 under NCCL: the dry run, the
    # distributed NTT at 2^26, MSM at 2^n (both accumulations) and EC-FFT
    # batch, and the sorted engine
    phase_dist(dev, card, pipe, bases, scalars, commitment, many_in, many_out)

    # 5. summary lines
    print(report.json_line(), flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                            "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
