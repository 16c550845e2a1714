"""Native C++ referee, loaded without JAX.

The tests check the port against the repository's native C++
implementation (``native/src/ec_native.cpp``, unchanged), and use it to
make 2^20 valid points fast.  ``tpu_ec.native`` imports jax
through ``tpu_ec/__init__.py``; this loader compiles the same source with
g++ into the port's build directory (``config.build_dir("native")``), its
file name keyed by a hash of source and flags.  Only the surface the port
needs is bound: field NTT, Montgomery product and conversion, half-limb
conversion, scalar multiplication, batch to-affine, Pippenger MSM and the
EC-group FFT.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading

import numpy as np

from .config import get_config
from .curves.params import CurveSpec
from .errors import EcError
from .fields.params import FieldSpec

_SRC = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "native", "src", "ec_native.cpp"
)
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lock = threading.Lock()
_lib = None


def _compile() -> str:
    with open(_SRC, "rb") as f:
        src = f.read()
    digest = hashlib.sha256(src + " ".join(_FLAGS).encode()).hexdigest()[:16]
    out = os.path.join(get_config().build_dir("native"), f"libec_native_{digest}.so")
    if not os.path.exists(out):
        tmp = out + f".tmp{os.getpid()}"
        res = subprocess.run(["g++", *_FLAGS, _SRC, "-o", tmp], capture_output=True, text=True)
        if res.returncode != 0:
            raise EcError(f"native build failed (g++ exit {res.returncode}):\n{res.stderr[-2000:]}")
        os.replace(tmp, out)
    return out


def _load():
    global _lib
    with _lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(_compile())
        u64p = ctypes.POINTER(ctypes.c_uint64)
        vp, i32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_long
        lib.ecn_field_new.restype = vp
        lib.ecn_field_new.argtypes = [u64p, i32]
        lib.ecn_field_free.argtypes = [vp]
        lib.ecn_field_mul.argtypes = [vp, u64p, u64p, u64p, i64, i32]
        lib.ecn_field_from_mont.argtypes = [vp, u64p, u64p, i64, i32]
        lib.ecn_ntt.argtypes = [vp, u64p, i32, u64p, i32]
        lib.ecn_curve_new.restype = vp
        lib.ecn_curve_new.argtypes = [vp, vp, i32]
        lib.ecn_curve_free.argtypes = [vp]
        lib.ecn_ec_to_affine.argtypes = [vp, u64p, u64p, i64, i32]
        lib.ecn_ec_scalar_mul.argtypes = [vp, u64p, u64p, u64p, i64, i32]
        lib.ecn_msm.argtypes = [vp, u64p, u64p, i64, i32, i32, u64p]
        lib.ecn_ec_fft.argtypes = [vp, u64p, i32, u64p, i32]
        _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64))


def _as_u64(a: np.ndarray, words: int) -> np.ndarray:
    a = np.ascontiguousarray(a, dtype=np.uint64)
    if a.shape[-1] != words:
        raise ValueError(f"expected last axis {words}, got {a.shape}")
    return a


def int_to_u64(value: int, words: int) -> np.ndarray:
    out = np.zeros(words, dtype=np.uint64)
    for i in range(words):
        out[i] = (value >> (64 * i)) & 0xFFFFFFFFFFFFFFFF
    if value >> (64 * words):
        raise ValueError("value does not fit")
    return out


def u64_to_int(limbs: np.ndarray) -> int:
    return sum(int(v) << (64 * i) for i, v in enumerate(limbs))


class NativeField:
    """Batched native field ops over (n, W64) u64 arrays, Montgomery form.

    W64 = 4 for 256-bit fields (Fr, BN254 Fq), 6 for BLS12-381 Fq — the
    native analog of the reference's Limb64 model (ag-build/src/source/limb.rs).
    """

    def __init__(self, spec: FieldSpec):
        lib = _load()
        self.lib = lib
        self.spec = spec
        self.w64 = -(-spec.modulus.bit_length() // 64)
        p = int_to_u64(spec.modulus, self.w64)
        self.handle = lib.ecn_field_new(_ptr(p), self.w64)
        if not self.handle:
            raise EcError(f"unsupported limb count {self.w64}")

    # -- conversions -------------------------------------------------------

    def from_ints(self, values, mont: bool = True) -> np.ndarray:
        out = np.zeros((len(values), self.w64), dtype=np.uint64)
        for i, v in enumerate(values):
            v = v % self.spec.modulus
            out[i] = int_to_u64(self.spec.to_mont(v) if mont else v, self.w64)
        return out

    def to_ints(self, a: np.ndarray, mont: bool = True) -> list:
        a = _as_u64(a, self.w64).reshape(-1, self.w64)
        return [
            self.spec.from_mont(u64_to_int(r)) if mont else u64_to_int(r)
            for r in a
        ]

    def from_halflimbs(self, a) -> np.ndarray:
        """(n, L) uint32 16-bit half-limbs (device layout) -> (n, w64) u64."""
        a = np.asarray(a, dtype=np.uint64).reshape(-1, self.spec.n_limbs)
        g = a.reshape(a.shape[0], self.w64, 4)
        shifts = np.uint64(16) * np.arange(4, dtype=np.uint64)
        return (g << shifts).sum(axis=-1, dtype=np.uint64)

    def to_halflimbs(self, a: np.ndarray) -> np.ndarray:
        a = _as_u64(a, self.w64).reshape(-1, self.w64)
        shifts = np.uint64(16) * np.arange(4, dtype=np.uint64)
        parts = (a[..., None] >> shifts) & np.uint64(0xFFFF)
        return parts.reshape(a.shape[0], self.spec.n_limbs).astype(np.uint32)

    # -- ops ----------------------------------------------------------------

    def _bin(self, fn, a, b, nthreads):
        a = _as_u64(a, self.w64)
        b = np.broadcast_to(_as_u64(b, self.w64), a.shape)
        b = np.ascontiguousarray(b)
        out = np.empty_like(a)
        n = a.size // self.w64
        fn(self.handle, _ptr(a), _ptr(b), _ptr(out), n, nthreads)
        return out

    def _un(self, fn, a, nthreads):
        a = _as_u64(a, self.w64)
        out = np.empty_like(a)
        fn(self.handle, _ptr(a), _ptr(out), a.size // self.w64, nthreads)
        return out

    def mul(self, a, b, nthreads: int = 0):
        return self._bin(self.lib.ecn_field_mul, a, b, nthreads)

    def from_mont(self, a, nthreads: int = 0):
        return self._un(self.lib.ecn_field_from_mont, a, nthreads)

    def ntt(self, a: np.ndarray, inverse: bool = False, nthreads: int = 0) -> np.ndarray:
        """In-place-style NTT over (n, w64) Montgomery values; returns a new
        array.  Convention matches ops/ntt.py (ark Radix2EvaluationDomain)."""
        a = np.array(_as_u64(a, self.w64), copy=True)
        n = a.shape[0]
        log_n = n.bit_length() - 1
        if 1 << log_n != n:
            raise ValueError("NTT size must be a power of two")
        p = self.spec.modulus
        omega = pow(self.spec.root_of_unity, 1 << (self.spec.two_adicity - log_n), p)
        if inverse:
            omega = pow(omega, p - 2, p)
        om = int_to_u64(omega, self.w64)
        self.lib.ecn_ntt(self.handle, _ptr(a), log_n, _ptr(om), nthreads)
        if inverse:
            ninv = self.from_ints([pow(n, -1, p)])
            a = self.mul(a, ninv, nthreads)
        return a

    def __del__(self):
        lib, h = getattr(self, "lib", None), getattr(self, "handle", None)
        if lib is not None and h:
            lib.ecn_field_free(h)
            self.handle = None


class NativeCurve:
    """Native scalar multiplication, to-affine, MSM and EC-FFT for one curve,
    G1 or G2 (ext = 2: coordinates in Fq2, c0's words then c1's).

    Point layout: Jacobian (n, 3*W64*ext), affine (n, 2*W64*ext), u64
    Montgomery coordinates, (0,0)/z=0 identity (GpuRepr parity,
    ag-types/src/impls.rs:48-58).  Scalars (n, 4) plain u64.
    """

    def __init__(self, spec: CurveSpec):
        if spec.ext not in (1, 2):
            raise ValueError(f"ext must be 1 (G1) or 2 (G2), got {spec.ext}")
        lib = _load()
        self.lib = lib
        self.spec = spec
        self.fq = NativeField(spec.base)
        self.fr = NativeField(spec.scalar)
        self.ext = spec.ext
        self.w = self.fq.w64 * spec.ext  # u64 words per coordinate
        self.handle = lib.ecn_curve_new(self.fq.handle, self.fr.handle, spec.ext)

    # -- conversions ---------------------------------------------------------

    def _coord_from_int(self, v) -> np.ndarray:
        """Plain coordinate (int, or (c0, c1) on G2) -> (w,) u64 Montgomery."""
        if self.ext == 1:
            return self.fq.from_ints([v])[0]
        return np.concatenate([self.fq.from_ints([v[0]])[0], self.fq.from_ints([v[1]])[0]])

    def _coord_to_int(self, limbs: np.ndarray):
        if self.ext == 1:
            return self.fq.to_ints(limbs[None, :])[0]
        h = self.fq.w64
        return (self.fq.to_ints(limbs[None, :h])[0], self.fq.to_ints(limbs[None, h:])[0])

    def coord_to_halflimbs(self, a: np.ndarray) -> np.ndarray:
        """(n, w) u64 coordinates -> (n, ext L) uint32 half-limbs, the
        port's layout (G2: c0's L half-limbs, then c1's)."""
        a = _as_u64(a, self.w).reshape(-1, self.fq.w64)
        return self.fq.to_halflimbs(a).reshape(-1, self.ext * self.spec.base.n_limbs)

    def coord_from_halflimbs(self, a) -> np.ndarray:
        """(n, ext L) half-limbs (the port's layout) -> (n, w) u64."""
        return self.fq.from_halflimbs(np.asarray(a, dtype=np.uint64).reshape(-1, self.spec.base.n_limbs)).reshape(
            -1, self.w)

    def affine_from_points(self, points) -> np.ndarray:
        """List of oracle affine points (None = identity) -> (n, 2w) u64."""
        out = np.zeros((len(points), 2 * self.w), dtype=np.uint64)
        for i, pt in enumerate(points):
            if pt is None:
                continue
            out[i, : self.w] = self._coord_from_int(pt[0])
            out[i, self.w :] = self._coord_from_int(pt[1])
        return out

    def affine_to_points(self, aff: np.ndarray) -> list:
        aff = _as_u64(aff, 2 * self.w).reshape(-1, 2 * self.w)
        out = []
        for row in aff:
            if not row.any():
                out.append(None)
            else:
                out.append((self._coord_to_int(row[: self.w]), self._coord_to_int(row[self.w :])))
        return out

    def scalars_from_ints(self, scalars) -> np.ndarray:
        out = np.zeros((len(scalars), 4), dtype=np.uint64)
        for i, s in enumerate(scalars):
            out[i] = int_to_u64(s % self.spec.scalar.modulus, 4)
        return out

    # -- ops -------------------------------------------------------------

    def to_affine(self, jac: np.ndarray, nthreads: int = 0) -> np.ndarray:
        jac = _as_u64(jac, 3 * self.w)
        n = jac.size // (3 * self.w)
        out = np.empty(jac.shape[:-1] + (2 * self.w,), dtype=np.uint64)
        self.lib.ecn_ec_to_affine(self.handle, _ptr(jac), _ptr(out), n, nthreads)
        return out

    def scalar_mul(self, aff: np.ndarray, scalars: np.ndarray, nthreads: int = 0) -> np.ndarray:
        aff = _as_u64(aff, 2 * self.w)
        scalars = _as_u64(scalars, 4)
        n = aff.size // (2 * self.w)
        out = np.empty(aff.shape[:-1] + (3 * self.w,), dtype=np.uint64)
        self.lib.ecn_ec_scalar_mul(self.handle, _ptr(aff), _ptr(scalars), _ptr(out), n, nthreads)
        return out

    def msm(self, aff: np.ndarray, scalars: np.ndarray, window: int = 0,
            nthreads: int = 0) -> np.ndarray:
        """Pippenger MSM (multiexp_cpu.rs:244-339 parity): (n, 2w) affine x
        (n, 4) plain scalars -> one (3w,) Jacobian point."""
        aff = _as_u64(aff, 2 * self.w).reshape(-1, 2 * self.w)
        scalars = _as_u64(scalars, 4).reshape(-1, 4)
        if aff.shape[0] != scalars.shape[0]:
            raise ValueError("bases and scalars differ in length")
        out = np.empty(3 * self.w, dtype=np.uint64)
        self.lib.ecn_msm(
            self.handle, _ptr(aff), _ptr(scalars), aff.shape[0], window, nthreads, _ptr(out)
        )
        return out

    def msm_points(self, points: list, scalars: list, window: int = 0,
                   nthreads: int = 0):
        """Oracle-typed MSM: affine int points + int scalars -> affine point."""
        j = self.msm(self.affine_from_points(points), self.scalars_from_ints(scalars),
                     window, nthreads)
        return self.affine_to_points(self.to_affine(j[None, :]))[0]

    def ec_fft(self, jac: np.ndarray, inverse: bool = False, nthreads: int = 0) -> np.ndarray:
        """EC-group FFT (ec_fft_cpu.rs parity) of (n, 3w) Jacobian points,
        n a power of two, natural order in and out; returns a new array.
        The inverse scales by n^-1 through to_affine and scalar_mul, so its
        Jacobian coordinates differ from the port's: compare affine."""
        jac = np.array(_as_u64(jac, 3 * self.w).reshape(-1, 3 * self.w), copy=True)
        n = jac.shape[0]
        log_n = n.bit_length() - 1
        if 1 << log_n != n:
            raise ValueError("EC-FFT size must be a power of two")
        fr = self.spec.scalar
        omega = pow(fr.root_of_unity, 1 << (fr.two_adicity - log_n), fr.modulus)
        if inverse:
            omega = pow(omega, fr.modulus - 2, fr.modulus)
        self.lib.ecn_ec_fft(self.handle, _ptr(jac), log_n, _ptr(int_to_u64(omega, 4)), nthreads)
        if inverse:
            ninv = self.scalars_from_ints([pow(n, -1, fr.modulus)])
            jac = self.scalar_mul(self.to_affine(jac, nthreads), np.broadcast_to(ninv, (n, 4)), nthreads)
        return jac

    def __del__(self):
        lib, h = getattr(self, "lib", None), getattr(self, "handle", None)
        if lib is not None and h:
            lib.ecn_curve_free(h)
            self.handle = None


@functools.lru_cache(maxsize=None)
def native_field(spec: FieldSpec) -> NativeField:
    return NativeField(spec)


@functools.lru_cache(maxsize=None)
def native_curve(spec: CurveSpec) -> NativeCurve:
    return NativeCurve(spec)
