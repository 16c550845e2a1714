"""Digit-matmul NTT: leaf transforms as exact int8 matrix products.

PyTorch counterpart of ``tpu_ec/ops/ntt_digit.py``; the algebra is the
same, and so are the constant tables (a test pins them equal).  A leaf NTT
is a constant linear map over the field, so with inputs split into base-2^7
digits it is an exact s8 x s8 -> s32 GEMM:

    col[e, k] = sum_{j, d} G[kj mod m][e, d] x[d, j]
    G[t][e, d] = digit_e(w_m^t 2^(7d) mod p)

Both operands are in [0, 127], so column sums stay below m * 37 * 127^2 <
2^31 (m <= 2^7 at the default leaf).  Between four-step levels the Bailey
twiddle T[k2, j1] is applied by kernel K2 (``kernels/inter.py``), which
carries the raw columns, multiplies by the 2^288-scaled twiddle with
R' = 2^288 and splits back to int8 digits; the last pass is K2 with one
constant twiddle and a canonical reduction.  Montgomery form passes through
untouched: the map is linear.

The leaf GEMM is ``torch._int_mm`` (int8 tensor cores) on CUDA and an int64
matmul on the CPU (int8 ``torch.mm`` wraps there).  Levels of 2^25 elements
or more (``tpu_ec``'s chunked levels) are not ported yet.
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..config import get_config
from ..fields.params import LIMB_BITS, FieldSpec, int_to_limbs
from ..kernels.inter import inter_twiddle
from .ntt import get_domain, twiddle_table_np

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1
WIDE_LIMBS = 18  # R' = 2^(16*18) = 2^288

# levels of at least this many elements run chunked in tpu_ec (the full
# Bailey table and raw-column tensor would not fit a 16 GiB chip); the port
# has no chunked level yet
_CHUNK_MIN = 1 << 25


def _digit_count(bits: int) -> int:
    return -(-bits // DIGIT_BITS)


def leaf_log(log_n: int) -> int:
    """Leaf radix log2 for a transform of 2^log_n (config, capped at log_n)."""
    return min(get_config().ntt_digit_leaf_log, log_n)


# ---------------------------------------------------------------------------
# numpy constant tables
# ---------------------------------------------------------------------------


def leaf_matrix_np(spec: FieldSpec, log_m: int, omega_m: int, d_in: int) -> np.ndarray:
    """(D_OUT, m, m, D_IN) int8: A[e,k,j,d] = digit_e(w_m^{kj} 2^{7d} mod p)."""
    p = spec.modulus
    m = 1 << log_m
    d_out = _digit_count(p.bit_length())
    G = np.zeros((m, d_out, d_in), np.int8)
    w_t = 1
    for t in range(m):
        v = w_t
        for d in range(d_in):
            x = v
            for e in range(d_out):
                G[t, e, d] = x & DIGIT_MASK
                x >>= DIGIT_BITS
            v = (v << DIGIT_BITS) % p
        w_t = (w_t * omega_m) % p
    k = np.arange(m)[:, None]
    j = np.arange(m)[None, :]
    return np.transpose(G[(k * j) % m], (2, 0, 1, 3)).copy()  # (e, k, j, d)


def _np_mont_mul_chunked(spec, a: np.ndarray, b: np.ndarray, chunk: int = 1 << 15) -> np.ndarray:
    """np_mont_mul in bounded-memory chunks (its (n, L, L) uint64
    temporaries would take gigabytes at n = 2^20)."""
    from ..fields.bigint import np_mont_mul

    n = a.shape[0]
    if n <= chunk:
        return np_mont_mul(spec, a, b)
    b = np.broadcast_to(np.asarray(b, np.uint64), a.shape)
    return np.concatenate(
        [np_mont_mul(spec, a[i : i + chunk], b[i : i + chunk]) for i in range(0, n, chunk)],
        axis=0,
    )


def inter_table_np(
    spec: FieldSpec, omega: int, log_n: int, log_m: int, log_n1: int
) -> np.ndarray:
    """(n2, n1, L) Montgomery table T[k2, j1] = w_m^{k2 j1} of the size-2^log_m
    level split into n1 = 2^log_n1 columns and n2 rows (w_m = omega^(n/m)).

    Row doubling: after round t the table holds rows k2 < 2^(t+1);
    multiplying the existing rows by cur[j1] = w_m^(j1 2^t) appends rows
    k2 + 2^t."""
    from ..fields.bigint import np_mont_mul

    L = spec.n_limbs
    n1 = 1 << log_n1
    n2 = 1 << (log_m - log_n1)
    w_m = pow(omega, 1 << (log_n - log_m), spec.modulus)
    table = np.broadcast_to(int_to_limbs(spec.one, L).astype(np.uint32), (1, n1, L)).copy()
    cur = twiddle_table_np(spec, w_m, log_n1)[:n1]
    for _ in range(log_m - log_n1):
        grown = _np_mont_mul_chunked(
            spec, table.reshape(-1, L), np.tile(cur, (table.shape[0], 1))
        ).reshape(table.shape[0], n1, L)
        table = np.concatenate([table, grown], axis=0)
        cur = np_mont_mul(spec, cur, cur)
    return table[:n2]


def inter_table288_np(
    spec: FieldSpec, omega: int, log_n: int, log_m: int, log_n1: int
) -> np.ndarray:
    """(L16, n2, n1) plain-twiddle table scaled by 2^288:
    T'[k2, j1] = w_m^{k2 j1} * 2^288 mod p.  One Montgomery product of the
    R-form table by C = 2^288 mod p converts: mont(t*R, C) = t * 2^288."""
    L = spec.n_limbs
    table = inter_table_np(spec, omega, log_n, log_m, log_n1)
    n2, n1 = table.shape[:2]
    C = int_to_limbs((1 << (16 * WIDE_LIMBS)) % spec.modulus, L)
    flat = _np_mont_mul_chunked(spec, table.reshape(-1, L), np.broadcast_to(C, (n2 * n1, L)))
    return np.transpose(flat.reshape(n2, n1, L), (2, 0, 1)).copy()


def cached_table(spec: FieldSpec, kind: str, key_parts, build):
    """Disk cache of one constant table under the build directory (the big
    twiddle tables take seconds of host Montgomery products at 2^20)."""
    cfg = get_config()
    if not cfg.cache:
        return build()
    d = cfg.cache_dir or cfg.build_dir("tables")
    os.makedirs(d, exist_ok=True)
    path = os.path.join(d, "_".join([spec.name, kind, *map(str, key_parts)]) + ".npy")
    if os.path.exists(path):
        return np.load(path)
    arr = build()
    tmp = f"{path}.tmp{os.getpid()}.npy"
    np.save(tmp, arr)
    os.replace(tmp, path)
    return arr


# ---------------------------------------------------------------------------
# digit plumbing
# ---------------------------------------------------------------------------


def split_digits_rows(v16: torch.Tensor, d_out: int) -> torch.Tensor:
    """(L16, ...) 16-bit limb planes -> (d_out, ...) int8 base-2^7 digits."""
    L16 = v16.shape[0]
    outs = []
    for e in range(d_out):
        i0, off = divmod(e * DIGIT_BITS, LIMB_BITS)
        if i0 >= L16:
            outs.append(torch.zeros_like(v16[0]))
            continue
        d = v16[i0] >> off
        if off > LIMB_BITS - DIGIT_BITS and i0 + 1 < L16:
            d = d | (v16[i0 + 1] << (LIMB_BITS - off))
        outs.append(d & DIGIT_MASK)
    return torch.stack(outs, dim=0).to(torch.int8)


def _leaf_gemm(A2: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """Leaf NTTs over axis 1 of x (d_in, m, M) int8 digits, batched over M:
    A2 is the (d_out * m, m * d_in) leaf matrix.  Returns (d_out, m, M) raw
    columns, int32 on CUDA (``torch._int_mm``) and int64 on the CPU."""
    d_in, m, M = x.shape
    rows, K = A2.shape
    xk = x.permute(1, 0, 2).reshape(m * d_in, M)
    if x.device.type == "cpu":
        out = A2.to(torch.int64) @ xk.to(torch.int64)
    else:
        # _int_mm wants more than 16 rows and K, N multiples of 8
        pad_k, pad_n = -K % 8, -M % 8
        if pad_k:
            A2 = torch.nn.functional.pad(A2, (0, pad_k))
            xk = torch.nn.functional.pad(xk, (0, 0, 0, pad_k))
        if pad_n:
            xk = torch.nn.functional.pad(xk, (0, pad_n))
        if rows <= 16:
            A2 = torch.nn.functional.pad(A2, (0, 0, 0, 17 - rows))
        out = torch._int_mm(A2.contiguous(), xk.contiguous())[:rows, :M]
    return out.reshape(rows // m, m, M).contiguous()


# ---------------------------------------------------------------------------
# domain + transform
# ---------------------------------------------------------------------------


class DigitDomain:
    """Constant tables of one (field, log_n, inverse, leaf) digit-matmul NTT."""

    def __init__(self, spec: FieldSpec, log_n: int, inverse: bool, leaf: int):
        if (1 << log_n) >= _CHUNK_MIN:
            raise NotImplementedError(
                f"digit NTT of 2^{log_n}: levels of 2^25 or more run chunked, not ported yet"
            )
        self.spec = spec
        self.log_n = log_n
        self.inverse = inverse
        self.leaf = leaf
        self.omega = get_domain(spec, log_n, inverse).omega
        p = spec.modulus
        self.d_in = _digit_count(LIMB_BITS * spec.n_limbs)  # inputs < 2^256
        self.plan = self._plan(log_n, leaf)
        mmax = 1 << max(self.plan)
        bound_bits = p.bit_length() + DIGIT_BITS + (mmax * self.d_in).bit_length()
        self.d_leaf = _digit_count(bound_bits)  # leaf output digits
        assert self.d_leaf * DIGIT_BITS <= LIMB_BITS * WIDE_LIMBS
        assert mmax * self.d_in * DIGIT_MASK * DIGIT_MASK < (1 << 31)
        self.matrices: dict[int, np.ndarray] = {}
        self.inter: dict[tuple[int, int], np.ndarray] = {}
        self._build()

    @staticmethod
    def _plan(log_n: int, leaf: int) -> list[int]:
        """Balanced factorisation: fewest levels with factors <= leaf, each
        factor as equal as possible (20, leaf 8 -> [7, 7, 6])."""
        k = -(-log_n // leaf)
        base, extra = divmod(log_n, k)
        return [base + (1 if i < extra else 0) for i in range(k)]

    def _leaf(self, lf: int):
        if lf not in self.matrices:
            w_m = pow(self.omega, 1 << (self.log_n - lf), self.spec.modulus)
            self.matrices[lf] = cached_table(
                self.spec, "leafmat", (int(self.inverse), lf, self.d_in),
                lambda: leaf_matrix_np(self.spec, lf, w_m, self.d_in),
            )

    def _build(self):
        spec, p = self.spec, self.spec.modulus
        log_rest = self.log_n
        for lf in self.plan[:-1]:
            n1_log = log_rest - lf
            self.inter[(log_rest, n1_log)] = cached_table(
                self.spec, "inter288", (self.log_n, int(self.inverse), log_rest, n1_log),
                lambda lr=log_rest, nl=n1_log: inter_table288_np(
                    spec, self.omega, self.log_n, lr, nl
                ),
            )
            self._leaf(lf)
            log_rest = n1_log
        self._leaf(self.plan[-1])
        # final cleanup constant: 2^288 (forward) / n^-1 * 2^288 (inverse)
        c = (1 << (LIMB_BITS * WIDE_LIMBS)) % p
        if self.inverse:
            c = (c * pow(1 << self.log_n, -1, p)) % p
        self.final_c = int_to_limbs(c, spec.n_limbs)


@functools.lru_cache(maxsize=16)
def get_digit_domain(spec: FieldSpec, log_n: int, inverse: bool, leaf: int) -> DigitDomain:
    return DigitDomain(spec, log_n, inverse, leaf)


def digit_consts(dom: DigitDomain, device) -> dict:
    """The domain's tables as tensors on ``device``: leaf matrices reshaped
    for the GEMM, Bailey tables and the final constant in storage dtype."""
    from ..fields.limbs import storage_dtype

    dt = storage_dtype(device)

    def limbs(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device).to(dt)

    A = {}
    for lf, mat in dom.matrices.items():
        d_out, m, _, d_in = mat.shape
        A[lf] = torch.as_tensor(mat.reshape(d_out * m, m * d_in), device=device)
    return {
        "A": A,
        "inter": {k: limbs(v) for k, v in dom.inter.items()},
        "final_c": limbs(dom.final_c),
    }


def _rec(dom: DigitDomain, x: torch.Tensor, log_m: int, consts: dict, level: int = 0):
    """x: (d_in, m, M) int8 digit planes (values < 2^256, R-domain) ->
    (d_out, m, M) raw column planes of the size-m NTT, natural order along
    axis 1.  Columns stay raw so the next K2 pass fuses their carry."""
    A, inter = consts["A"], consts["inter"]
    if level == len(dom.plan) - 1:
        return _leaf_gemm(A[log_m], x)
    d_in, _, M = x.shape
    log_n2 = dom.plan[level]
    log_n1 = log_m - log_n2
    n1, n2 = 1 << log_n1, 1 << log_n2
    # leaf NTT over j2 (axis 1), batched over (j1, M)
    cols = _leaf_gemm(A[log_n2], x.reshape(d_in, n2, n1 * M))  # (d_out, n2, n1*M)
    T = inter[(log_m, log_n1)]  # (L16, n2, n1)
    tfull = T[:, :, :, None].expand(T.shape[0], n2, n1, M).reshape(T.shape[0], n2 * n1 * M)
    y = inter_twiddle(dom.spec, cols.reshape(cols.shape[0], n2 * n1 * M), tfull.contiguous())
    # transpose and recurse over n1
    yt = y.reshape(dom.d_in, n2, n1, M).transpose(1, 2).reshape(dom.d_in, n1, n2 * M)
    z = _rec(dom, yt, log_n1, consts, level + 1)
    # k1-major flatten == natural order (X[k2 + n2*k1] = Z[k1, k2])
    return z.reshape(z.shape[0], n1 * n2, M)


def digit_ntt_planes(
    spec: FieldSpec,
    xp: torch.Tensor,  # (L16, n) half-limb planes, Montgomery form
    inverse: bool = False,
    *,
    leaf: int | None = None,
    consts: dict | None = None,
) -> torch.Tensor:
    """Natural-order NTT bit-exact with ops.ntt.FftKernel.  Returns (L16, n)
    canonical Montgomery planes (< p) in the storage dtype."""
    L16, n = xp.shape
    log_n = int(n).bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("FFT size must be a power of two")
    leaf = leaf_log(log_n) if leaf is None else min(leaf, log_n)
    dom = get_digit_domain(spec, log_n, inverse, leaf)
    if consts is None:
        consts = digit_consts(dom, xp.device)
    dig = split_digits_rows(xp, dom.d_in)[:, :, None]  # (d_in, n, 1)
    out = _rec(dom, dig, log_n, consts)
    return inter_twiddle(
        spec, out.reshape(out.shape[0], n), consts["final_c"], canonical=True, const_t=True
    )
