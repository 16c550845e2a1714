"""Build and load the CUDA kernels (csrc/*.cu) as one shared library.

The sources are compiled at first use with ``nvcc`` for ``sm_90a`` into one
``.so`` with a plain C interface, loaded with ctypes (no PyTorch headers, so
the build takes seconds).  Each source is one nvcc process, all started
together; K3's G2 instances have sources of their own (``g2_point.cu``,
and ``g2_*.cu`` on the templates of ``chain.cuh``), so that the widest
instances build side by side.  The library's file name embeds a hash of the
sources and flags; it lives in the gitignored build directory
(``config.build_dir("kernels")``), beside the ``-Xptxas -v`` report of the
build.  Nothing here runs at import: the CPU tests import every module.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from concurrent.futures import ThreadPoolExecutor

import torch

from ..config import get_config
from ..errors import DeviceError
from ..fields.params import FieldSpec
from ..utils.timer import phase

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
# one nvcc process each, all started together (the longest compiles first)
SOURCES = (
    "g2_horner.cu", "g2_scalar_mul.cu", "g2_ec_fft_stage.cu", "g2_lattice.cu", "g2_point.cu", "chain.cu", "point.cu",
    "mont.cu", "inter.cu", "ntt.cu", "affine.cu",
)
HEADERS = ("field.cuh", "field_tile.cuh", "point_args.cuh", "point.cuh", "chain.cuh")
ARCH = ("-gencode", "arch=compute_90a,code=sm_90a")
FLAGS = (*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_lock = threading.Lock()
_lib: ctypes.CDLL | None = None


class Launches:
    """Launch count of one kernel wrapper: it adds one where it launches its
    kernel and nowhere else, so a run can show which kernels it went through."""

    def __init__(self, name: str):
        self.name = name
        self.count = 0


def _nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise DeviceError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for name in HEADERS + SOURCES:
        with open(os.path.join(CSRC, name), "rb") as f:
            h.update(name.encode() + f.read())
    return h.hexdigest()[:16]


def library_path() -> str:
    return os.path.join(get_config().build_dir("kernels"), f"libtec_kernels_{_digest()}.so")


def ptxas_report() -> str:
    """The ``-Xptxas -v`` output of the build (registers, spills per kernel)."""
    with open(library_path() + ".ptxas.txt") as f:
        return f.read()


def _compile(cmd: list) -> tuple[int, str]:
    res = subprocess.run(cmd, capture_output=True, text=True)
    return res.returncode, res.stderr


def build() -> float:
    """Compile the library if it is not built yet; returns the seconds taken.

    One nvcc per source (``SOURCES``), all started together, then one link."""
    out = library_path()
    if os.path.exists(out):
        return 0.0
    t0 = time.perf_counter()
    tmp = f"{out}.tmp{os.getpid()}"
    nvcc = _nvcc()
    objs = [f"{tmp}.{os.path.splitext(src)[0]}.o" for src in SOURCES]
    with ThreadPoolExecutor(len(SOURCES)) as pool:
        runs = list(pool.map(_compile, ([nvcc, *FLAGS, "-c", "-o", obj, os.path.join(CSRC, src)]
                                        for src, obj in zip(SOURCES, objs))))
    for src, (rc, err) in zip(SOURCES, runs):
        if rc != 0:
            raise DeviceError(f"nvcc failed on {src} ({rc}):\n{err[-4000:]}")
    res = subprocess.run([nvcc, *ARCH, "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    for obj in objs:
        os.remove(obj)
    if res.returncode != 0:
        raise DeviceError(f"nvcc link failed ({res.returncode}):\n{res.stderr[-4000:]}")
    with open(out + ".ptxas.txt", "w") as f:
        f.write("".join(err for _, err in runs))
    os.replace(tmp, out)
    return time.perf_counter() - t0


def load() -> ctypes.CDLL:
    """The loaded kernel library (built on first call)."""
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        with phase("build/kernels"):
            build()
            lib = ctypes.CDLL(library_path())
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        lib.tec_mont_mul.argtypes = [i32, vp, vp, vp, i64, i64, vp, vp]
        lib.tec_mont_mul.restype = i32
        lib.tec_inter.argtypes = [vp, i32, i32, vp, i32, i64, vp, i32, i32, i64, vp, vp]
        lib.tec_inter.restype = i32
        for sfx in ("", "_fp2"):  # K3's G1 entries and their G2 (Fq2) twins
            for name, args in (
                ("tec_point", [i32, i32, vp, vp, vp, vp, i64, i64, vp, vp]),
                ("tec_point_horner", [i32, vp, vp, i32, i64, i32, vp, vp, vp]),
                ("tec_point_scalar_mul", [i32, vp, vp, vp, i64, vp, i64, vp, vp]),
                ("tec_ec_fft_stage", [i32, vp, i64, vp, vp, i64, i32, i32, vp, vp]),
                ("tec_point_lattice", [i32, vp, i64, vp, i64, vp, i32, i64, i32, i32, vp, vp, vp, vp]),
            ):
                fn = getattr(lib, name + sfx)
                fn.argtypes, fn.restype = args, i32
        lib.tec_mul_chain.argtypes = [i32, vp, vp, i32, vp, vp, vp]
        lib.tec_mul_chain.restype = i32
        lib.tec_chain_tile.argtypes = [i32, i32]
        lib.tec_chain_tile.restype = i32
        lib.tec_pease_rows_fit.argtypes = [i32, i32]
        lib.tec_pease_rows_fit.restype = i32
        lib.tec_pease_rows.argtypes = [i32, vp, vp, vp, i64, i32, i32, i32, i32, vp, vp]
        lib.tec_pease_rows.restype = i32
        lib.tec_pease_stage.argtypes = [i32, vp, vp, vp, i64, i32, i32, i32, vp, vp]
        lib.tec_pease_stage.restype = i32
        lib.tec_ntt_leaf.argtypes = [i32, vp, vp, vp, vp, i32, i64, i64, vp, vp]
        lib.tec_ntt_leaf.restype = i32
        lib.tec_affine.argtypes = [i32, i32, vp, vp, vp, i64, i64, vp, vp, i64, vp, vp]
        lib.tec_affine.restype = i32
        lib.tec_error_string.argtypes = [i32]
        lib.tec_error_string.restype = ctypes.c_char_p
        _lib = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    if err != 0:
        raise DeviceError(f"{what}: CUDA error {err} ({lib.tec_error_string(err).decode()})")


def stream() -> int:
    return torch.cuda.current_stream().cuda_stream


_FC: dict = {}


def field_consts(spec: FieldSpec):
    """Host array [n', p words (12), one words (12)] the kernels take."""
    if spec.name not in _FC:
        nw = spec.n_limbs // 2
        words = lambda v: [(v >> (32 * i)) & 0xFFFFFFFF for i in range(nw)] + [0] * (12 - nw)
        vals = [spec.inv32] + words(spec.modulus) + words(spec.one)
        _FC[spec.name] = (ctypes.c_uint32 * len(vals))(*vals)
    return _FC[spec.name]


def check_cuda(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of ``dtype`` (and shape)."""
    if t.device.type != "cuda":
        raise DeviceError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise DeviceError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise DeviceError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise DeviceError(f"{name}: expected a contiguous tensor")


def aligned(t: torch.Tensor) -> torch.Tensor:
    """``t``, or a copy of it where its data does not start on 16 bytes (the
    kernels that move rows in 16-byte vectors need that)."""
    return t if t.data_ptr() % 16 == 0 else t.clone()


def row_views(what: str, coords, L: int) -> list[torch.Tensor]:
    """Coordinates of one shape (..., L), int32 on one CUDA device, each as
    an (n, L) view whose last axis is contiguous (a column slice of a fused
    row matrix stays a view: its row stride goes to the kernel)."""
    shape = coords[0].shape
    if coords[0].device.type != "cuda":
        raise DeviceError(f"{what}: expected CPU or CUDA tensors, got {coords[0].device}")
    if shape[-1] != L:
        raise ValueError(f"{what}: last axis must be {L} half-limbs, got {tuple(shape)}")
    flat = []
    for k, c in enumerate(coords):
        if c.device != coords[0].device or c.dtype != torch.int32 or c.shape != shape:
            raise ValueError(
                f"{what}: coordinate {k} is {c.dtype} {tuple(c.shape)} on {c.device}; "
                f"expected int32 {tuple(shape)} on {coords[0].device}"
            )
        f = c.reshape(-1, L)
        if f.stride(-1) != 1:
            f = f.contiguous()
        flat.append(f)
    return flat
