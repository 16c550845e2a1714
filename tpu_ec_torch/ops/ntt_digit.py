"""Digit-matmul NTT: leaf transforms as exact int8 matrix products.

PyTorch counterpart of ``tpu_ec/ops/ntt_digit.py``; the algebra is the
same, and so are the constant tables (a test pins them equal).  A leaf NTT
is a constant linear map over the field, so with inputs split into base-2^7
digits it is an exact s8 x s8 -> s32 GEMM:

    col[e, k] = sum_{j, d} G[kj mod m][e, d] x[d, j]
    G[t][e, d] = digit_e(w_m^t 2^(7d) mod p)

Both operands are in [0, 127], so column sums stay below m * 37 * 127^2 <
2^31 (m <= 2^8 at the default leaf).  Between four-step levels the Bailey
twiddle T[k2, j1] is applied by kernel K2 (``kernels/inter.py``), which
carries the raw columns, multiplies by the 2^288-scaled twiddle with
R' = 2^288 and splits back to int8 digits; the last pass is K2 with one
constant twiddle and a canonical reduction.  Montgomery form passes through
untouched: the map is linear.

The Bailey table of a level comes by one of tpu_ec's three routes: host
numpy below ``_DEVICE_TABLE_MIN`` elements, row doubling with kernel K1 on
the tensor's device from there, and from ``_CHUNK_MIN`` factored seeds
only, each chunk of the level synthesising its block of the table with
K1.  A transform of ``_CHUNK_MIN`` elements or more runs every level in
``_CHUNK_COUNT`` slices of the leaf-output axis k2 and its last GEMM in
slices of the batch axis, so that no full raw-column tensor exists; the
last slices' K2 pass (twiddle 2^288, a carry to digits that keeps the
value mod p) hands the final pass int8 digits, K2's int8 entry.  A module
constant patched at run time takes effect for the domains built after it.

The leaf GEMM is ``torch._int_mm`` (int8 tensor cores) on CUDA and an int64
matmul on the CPU (int8 ``torch.mm`` wraps there).  Its data operand is
K-major: a contiguous (N, K) matrix, GEMM column n = (j1, M) holding the
m * d_in digits K = (j2, d) of its leaf inputs side by side, passed to
``_int_mm`` as its ``.t()``.  cuBLASLt then sees a TN product, the layout
its int8 IMMA kernels take; a row-major (K, N) operand makes it an NN
product, which only CUTLASS's SM80 WMMA fallback runs (5.0-6.5x slower at
the digit NTT's shapes on an H100, ``utils/leaf_gemm_probe.py`` at 2a4dbb4).
K2 writes digit planes (d, ...), so each level boundary is one transposing
copy from K2's planes into the next level's K-major operand
(``_to_kmajor``); the first level's operand is split from the input
into that layout (``_split_first``).
"""

from __future__ import annotations

import functools
import os

import numpy as np
import torch

from ..config import get_config
from ..fields.limbs import storage_dtype
from ..fields.params import LIMB_BITS, FieldSpec, int_to_limbs
from ..kernels.inter import inter_twiddle
from ..kernels.mont import mont_mul
from ..utils.timer import phase
from .ntt import get_domain, twiddle_table_np

DIGIT_BITS = 7
DIGIT_MASK = (1 << DIGIT_BITS) - 1
WIDE_LIMBS = 18  # R' = 2^(16*18) = 2^288

# a level's Bailey table of at least this many elements is built with K1 on
# the tensor's device.  On the card's machine the host numpy table
# (inter_table288_np, numpy Montgomery on one thread) took 2.18 s at 2^16,
# 8.68 s at 2^18, 33.00 s at 2^20 and 144.37 s at 2^22, and K1 built each
# table in 1.6-4.2 ms (H100 80GB HBM3, 700 W; utils/table_times.py at 2a4dbb4).
# tpu_ec's 2^22 weighed a TPU host's minutes; below 2^16 the tables stay
# on the host and its disk cache, as tpu_ec's are
_DEVICE_TABLE_MIN = 1 << 16
# transforms of at least this many elements run chunked, and levels of at
# least this many keep factored seeds instead of a table.  tpu_ec's 2^25
# fitted a 16 GiB chip.  One unchunked level of 2^26 holds 10 GiB of raw
# int32 columns (40 x 2^26) and 2.3 GiB each of GEMM operand and int8
# digits out, beside a 4 GiB cached table a direction and the 4 GiB input
# and output: on the card the unchunked 2^26 forward took 635.6 ms at
# 13.25 GiB above what it holds, the chunked 791.3 ms at 11.08 GiB
# (chip_smoke.py phase 4h at 2a4dbb4; H100 80GB HBM3, 700 W), so 2^26 stays
# unchunked beside the commit's 12.9 GB of 2^26 G1 bases.  At 2^27 a level
# doubles to ~27 GiB and the tables to 16 GiB for both directions; the
# chunked 2^27 inverse took 1745.8 ms, its peak 13.5 GiB with its 8 GiB
# output (benchmark cell ntt-inv-2p27; H100 80GB HBM3, 700 W)
_CHUNK_MIN = 1 << 27
_CHUNK_COUNT = 16


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


def _limbs(a, device) -> torch.Tensor:
    """A numpy limb array as a tensor of the storage dtype on ``device``."""
    return torch.as_tensor(np.ascontiguousarray(a, np.int64), device=device).to(storage_dtype(device))


def _c288(spec: FieldSpec) -> np.ndarray:
    """2^288 mod p as limbs: the seed row of a 2^288-scaled table."""
    return int_to_limbs((1 << (LIMB_BITS * WIDE_LIMBS)) % spec.modulus, spec.n_limbs)


def _powers_row(spec: FieldSpec, omega: int, log_n: int, log_m: int, log_n1: int, device) -> torch.Tensor:
    """(n1, L) R-form row w_m^j1 of one level (w_m = omega^(n/m)), built on
    ``device`` with K1 by the doubling ``twiddle_table_np`` runs on the host
    (tpu_ec's ``curpow0``), so the values are the same: row r .. 2r - 1 is
    rows 0 .. r - 1 times w_m^r; log2(n1) launches."""
    L, p = spec.n_limbs, spec.modulus
    w_pow = pow(omega, 1 << (log_n - log_m), p)
    row = torch.empty((1 << log_n1, L), dtype=storage_dtype(device), device=device)
    row[0] = _limbs(int_to_limbs(spec.one, L), device)
    r = 1
    while r < row.shape[0]:
        mont_mul(spec, row[:r], _limbs(int_to_limbs(spec.to_mont(w_pow), L), device), out=row[r : 2 * r])
        w_pow = w_pow * w_pow % p
        r *= 2
    return row


def inter_table288_device(
    spec: FieldSpec, omega: int, log_n: int, log_m: int, log_n1: int, device
) -> torch.Tensor:
    """(n2, n1, L) rows of the 2^288-scaled table T'[k2, j1] = w_m^(k2 j1)
    * 2^288 mod p (the transpose of ``inter_table288_np``'s planes), built
    on ``device`` by row doubling with kernel K1 (its plain version on the
    CPU), as tpu_ec's ``inter_table288_device``.

    The rows stay in 2^288-scaled plain form (seed row C = 2^288 mod p)
    while the multiplier cur[j1] = w_m^(j1 2^t) stays in R-form, so
    mont(t * 2^288, cur * R) = t * cur * 2^288: each round writes rows
    r .. 2r - 1 as rows 0 .. r - 1 times cur, then squares cur; log2(n2)
    launches write the table and log2(n2) - 1 square, after the log2(n1) of
    the first cur."""
    L = spec.n_limbs
    n1, n2 = 1 << log_n1, 1 << (log_m - log_n1)
    cur = _powers_row(spec, omega, log_n, log_m, log_n1, device)
    table = torch.empty((n2, n1, L), dtype=storage_dtype(device), device=device)
    table[0] = _limbs(_c288(spec), device)
    r = 1
    while r < n2:
        mont_mul(spec, table[:r], cur, out=table[r : 2 * r])
        r *= 2
        if r < n2:
            cur = mont_mul(spec, cur, cur)
    return table


def _factored_seeds(dom: "DigitDomain", log_m: int, log_n1: int, device) -> dict:
    """Seeds of one level's chunked twiddle synthesis (tpu_ec's
    ``_factored_seeds``): ``cur_pows[t]`` the (n1, L) R-form row
    w_m^(2^t j1), t < log2(n2), and ``c_row`` the (n1, L) seed row of
    C = 2^288 mod p.  log2(n1) K1 launches build the first row and
    log2(n2) - 1 square it."""
    spec = dom.spec
    pows = [_powers_row(spec, dom.omega, dom.log_n, log_m, log_n1, device)]
    for _ in range(log_m - log_n1 - 1):
        pows.append(mont_mul(spec, pows[-1], pows[-1]))
    c_row = _limbs(_c288(spec), device).expand(1 << log_n1, spec.n_limbs).contiguous()
    return {"cur_pows": pows, "c_row": c_row}


# ---------------------------------------------------------------------------
# digit plumbing
# ---------------------------------------------------------------------------


def split_digits_rows(v16: torch.Tensor, d_out: int) -> torch.Tensor:
    """(L16, ...) 16-bit limb planes -> (d_out, ...) int8 base-2^7 digits,
    cast one digit plane at a time (no int32 stack of all of them)."""
    L16 = v16.shape[0]
    out = torch.empty((d_out,) + tuple(v16.shape[1:]), dtype=torch.int8, device=v16.device)
    for e in range(d_out):
        i0, off = divmod(e * DIGIT_BITS, LIMB_BITS)
        if i0 >= L16:
            out[e] = 0
            continue
        d = v16[i0] >> off
        if off > LIMB_BITS - DIGIT_BITS and i0 + 1 < L16:
            d = d | (v16[i0 + 1] << (LIMB_BITS - off))
        out[e] = d & DIGIT_MASK
    return out


# the transposing copies move words of this many digits where the planes'
# innermost axis allows: the word transpose moves 1/g of the elements a
# byte transpose would, and the regrouping of each word's g digits stays
# inside one row group
_WORDS = ((8, torch.int64), (4, torch.int32), (2, torch.int16))
# an unchunked level's transposing copy runs in slices of k2 of at most this
# many bytes (2^26: 16 slices of its 2.3 GiB of digits)
_COPY_BYTES = 1 << 28


def _to_kmajor(y: torch.Tensor, sizes, order, out: torch.Tensor) -> None:
    """Copy int8 digit planes y, (d, *sizes) with the axes after d
    contiguous, into ``out``, laid out (*(sizes[o] for o in order), d): the
    digits of each position side by side, as the leaf GEMM's K-major
    operand holds them.  ``out`` may be a strided view (a slice of an
    operand).

    A byte transpose with d reads each byte from another plane.  Instead
    the planes' innermost axis is read as words of g digits (g = 8, 4 or
    2, the largest that divides it; plain bytes otherwise), the words are
    transposed with d, and a second copy, local to the g rows of a word,
    moves each word's g digits to their rows."""
    d = y.shape[0]
    keep = [i for i, s in enumerate(sizes) if s > 1]
    sizes = [sizes[i] for i in keep]
    order = [keep.index(o) for o in order if o in keep]
    y = y.view(d, *sizes)
    out = out.view(*(sizes[o] for o in order), d)
    last = len(sizes) - 1
    g, word = next(((g, w) for g, w in _WORDS if sizes and sizes[last] % g == 0), (1, None))
    if g == 1:
        out.copy_(y.permute(*(o + 1 for o in order), 0))
        return
    t = y.view(word).permute(*(o + 1 for o in order), 0).contiguous().view(torch.int8)
    p = order.index(last)
    shape = [sizes[o] for o in order]
    shape[p] //= g
    t = t.view(*shape, d, g)
    nd = len(shape)
    out = out.view(*shape[: p + 1], g, *shape[p + 1 :], d)
    out.copy_(t.permute(*range(p + 1), nd + 1, *range(p + 1, nd + 1)))


def _leaf_rhs(N: int, K: int, device) -> tuple[torch.Tensor, torch.Tensor]:
    """The leaf GEMM's data operand, K-major: a contiguous (N, K) int8
    matrix whose row n holds GEMM column n's K = m * d_in digits (j2, d),
    so that ``torch._int_mm`` gets it as ``.t()``, a TN product, the layout
    of cuBLASLt's int8 IMMA kernels.  On CUDA N and K are padded to
    multiples of 8 with zeros, as ``_int_mm`` wants.  Returns (the operand
    to hand ``_leaf_mm``, its (N, K) region to fill)."""
    Np, Kp = (N, K) if device.type == "cpu" else (N + (-N % 8), K + (-K % 8))
    buf = (torch.empty if (Np, Kp) == (N, K) else torch.zeros)((Np, Kp), dtype=torch.int8, device=device)
    return buf, buf[:N, :K]


def _split_first(v16: torch.Tensor, out: torch.Tensor, d: int, block: int = 1 << 22) -> None:
    """Limb values v16, (L16, n2, n1, M) with n = (j2, j1), any strides ->
    the first level's K-major operand ``out``, (n1, M, n2, d) digits.  In
    blocks of j1 with every j2 and M, so that no digit planes of the whole
    input are held: a block is split into digit planes and copied digits
    innermost (``_to_kmajor``).  Limbs innermost (rows) go through one
    transposed int32 copy of the block first, not a strided read a digit."""
    L16, n2, n1, M = v16.shape
    b = max(1, min(n1, block // (n2 * M)))
    for t in range(0, n1, b):
        blk = v16[:, :, t : t + b]
        if blk.stride(0) == 1:
            blk = blk.contiguous()
        planes = split_digits_rows(blk, d)  # (d, j2, j1, M)
        _to_kmajor(planes, planes.shape[1:], (1, 2, 0), out[t : t + b])


# leaf GEMMs so far by the layout of the data operand the product reads:
# "k_major" (each column's K digits contiguous: TN on CUDA) or "n_major".
# Not a hand kernel's launches, so not in kernels.launch_counters()
_LEAF_MM = {"k_major": 0, "n_major": 0}


def leaf_mm_counts() -> dict:
    """{operand layout: leaf GEMMs so far}, on every device."""
    return dict(_LEAF_MM)


def _leaf_mm(A2: torch.Tensor, xk: torch.Tensor, N: int) -> torch.Tensor:
    """Rows of the leaf matrix A2 (rows, m * d_in) times the K-major operand
    ``xk`` of ``_leaf_rhs`` (or a block of its rows): (rows, N) raw columns,
    int32 on CUDA (``torch._int_mm(A2, xk.t())``, a TN product) and int64 on
    the CPU."""
    rows, K = A2.shape
    _LEAF_MM["k_major" if xk.stride(1) == 1 else "n_major"] += 1
    if xk.device.type == "cpu":
        return A2.to(torch.int64) @ xk.t().to(torch.int64)
    # _int_mm wants more than 16 rows and K, N multiples of 8
    if xk.shape[1] != K:
        A2 = torch.nn.functional.pad(A2, (0, xk.shape[1] - K))
    if rows <= 16:
        A2 = torch.nn.functional.pad(A2, (0, 0, 0, 17 - rows))
    out = torch._int_mm(A2.contiguous(), xk.t())
    return out if out.shape == (rows, N) else out[:rows, :N].contiguous()


# ---------------------------------------------------------------------------
# domain + transform
# ---------------------------------------------------------------------------


class DigitDomain:
    """Constant tables of one (field, log_n, inverse, leaf) digit-matmul NTT,
    and the routes of its levels: ``inter[(log_m, log_n1)]`` is the host
    table (a numpy (L16, n2, n1) array), "device" (K1 builds it in
    ``digit_consts``) or "factored" (seeds only; the level runs chunked).
    The thresholds are the module constants when the domain is built."""

    def __init__(self, spec: FieldSpec, log_n: int, inverse: bool, leaf: int):
        self.spec = spec
        self.log_n = log_n
        self.inverse = inverse
        self.leaf = leaf
        self.chunk_min, self.device_table_min, self.chunk_count = _CHUNK_MIN, _DEVICE_TABLE_MIN, _CHUNK_COUNT
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
        self.inter: dict[tuple[int, int], np.ndarray | str] = {}
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
            if (1 << log_rest) >= self.chunk_min:
                self.inter[(log_rest, n1_log)] = "factored"
            elif (1 << log_rest) >= self.device_table_min:
                self.inter[(log_rest, n1_log)] = "device"
            else:
                self.inter[(log_rest, n1_log)] = cached_table(
                    self.spec, "inter288", (self.log_n, int(self.inverse), log_rest, n1_log),
                    lambda lr=log_rest, nl=n1_log: inter_table288_np(spec, self.omega, self.log_n, lr, nl),
                )
            self._leaf(lf)
            log_rest = n1_log
        self._leaf(self.plan[-1])
        # final cleanup constant: 2^288 (forward) / n^-1 * 2^288 (inverse)
        c = (1 << (LIMB_BITS * WIDE_LIMBS)) % p
        if self.inverse:
            c = (c * pow(1 << self.log_n, -1, p)) % p
        self.final_c = int_to_limbs(c, spec.n_limbs)


def get_digit_domain(spec: FieldSpec, log_n: int, inverse: bool, leaf: int) -> DigitDomain:
    """The cached domain under the module's current thresholds."""
    return _digit_domain(spec, log_n, inverse, leaf, _CHUNK_MIN, _DEVICE_TABLE_MIN, _CHUNK_COUNT)


@functools.lru_cache(maxsize=16)
def _digit_domain(spec, log_n, inverse, leaf, *thresholds) -> DigitDomain:
    with phase("build/digit_domain"):
        return DigitDomain(spec, log_n, inverse, leaf)  # the thresholds only key the cache


def digit_consts(dom: DigitDomain, device) -> dict:
    """The domain's tables as tensors on ``device``: leaf matrices reshaped
    for the GEMM, each level's Bailey table as (n2, n1, L) rows (uploaded,
    or built with K1) or its factored seeds, and the constants of the last
    passes in storage dtype.  A materialised table of 2^26 elements takes
    4 GiB."""
    with phase("build/digit_consts"):
        A = {}
        for lf, mat in dom.matrices.items():
            d_out, m, _, d_in = mat.shape
            A[lf] = torch.as_tensor(mat.reshape(d_out * m, m * d_in), device=device)
        inter = {}
        for (log_m, log_n1), v in dom.inter.items():
            if isinstance(v, np.ndarray):
                inter[(log_m, log_n1)] = _limbs(np.transpose(v, (1, 2, 0)), device)
            elif v == "factored":
                inter[(log_m, log_n1)] = _factored_seeds(dom, log_m, log_n1, device)
            else:
                inter[(log_m, log_n1)] = inter_table288_device(
                    dom.spec, dom.omega, dom.log_n, log_m, log_n1, device)
        return {"A": A, "inter": inter, "final_c": _limbs(dom.final_c, device),
                "c288": _limbs(_c288(dom.spec), device)}


def _chunked_level(dom: DigitDomain, A2, xk, T, n1: int, n2: int, M: int, nxt: torch.Tensor) -> None:
    """One four-step level in nc slices of the leaf-output axis k2, so the
    full raw-column tensor never exists (tpu_ec's ``_chunked_level``).
    ``xk`` is the level's K-major GEMM operand; slice a's rows of A2 (row
    e * n2 + k2, strided) are gathered once into a small block.  The
    slice's (c, n1) twiddle block is sliced from a materialised table, or
    with factored seeds (a dict) synthesised with K1 as mont(base,
    w^(a j1)): base rows 0 .. c - 1 by doubling from the seed row (log2(c)
    launches a level), the row of powers as a product of the seeds of a's
    bits (popcount(a / c) launches a slice, none for slice 0).  Each
    slice's digits go straight into its rows of the next level's operand,
    ``nxt`` viewed (n1', n2, M, n2', d_in)."""
    spec = dom.spec
    L = spec.n_limbs
    nc = min(dom.chunk_count, n2)
    c = n2 // nc
    logc = c.bit_length() - 1
    N = n1 * M
    d_out = A2.shape[0] // n2
    A3 = A2.view(d_out, n2, A2.shape[1])
    n1p, n2p = nxt.shape[0], nxt.shape[3]
    factored = isinstance(T, dict)
    if factored:
        with phase("ntt/chunk/seeds"):
            pows = T["cur_pows"]
            base = torch.empty((c, n1, L), dtype=T["c_row"].dtype, device=xk.device)
            base[0] = T["c_row"]
            r = 1
            while r < c:
                mont_mul(spec, base[:r], pows[r.bit_length() - 1], out=base[r : 2 * r])
                r *= 2
    for ci in range(nc):
        a = ci * c
        with phase("ntt/chunk/leaf_mm"):
            cols = _leaf_mm(A3[:, a : a + c].reshape(d_out * c, A2.shape[1]), xk, N)
        if factored:
            with phase("ntt/chunk/row"):
                row, t, bits = None, logc, ci
                while bits:
                    if bits & 1:
                        row = pows[t] if row is None else mont_mul(spec, row, pows[t])
                    bits >>= 1
                    t += 1
                tchunk = base if row is None else mont_mul(spec, base, row)
        else:
            tchunk = T[a : a + c]
        with phase("ntt/chunk/inter_twiddle"):
            y_c = inter_twiddle(spec, cols.view(d_out, c * N), tchunk.reshape(c * n1, L), t_rep=M)
        del cols
        with phase("ntt/chunk/transpose"):
            _to_kmajor(y_c, (c, n2p, n1p, M), (2, 0, 3, 1), nxt[:, a : a + c])
        del y_c


def _transform(dom: DigitDomain, consts: dict, first, M: int, out_rows: bool = False) -> torch.Tensor:
    """``first(n2, n1)`` makes the first level's K-major GEMM operand (the
    ``_leaf_rhs`` of N = n1 * M columns, K = n2 * d_in) of M interleaved
    transforms of n = n2 * n1 (values < 2^256, R-form), which this call
    alone holds: each level frees its operand before the next (at 2^27 each
    is 4.6 GiB).  Returns the canonical (16, n * M) planes, or with
    ``out_rows`` (n * M, 16) rows.

    Each level of the plan runs the leaf NTT over j2 as one GEMM batched
    over (j1, M), TN on its K-major operand, and K2 with the Bailey twiddle
    (column i's twiddle at i // M); one transposing copy takes K2's digit
    planes (d, k2, j2', j1', M) to the next level's operand, columns
    (j1', k2, M) and K = (j2', d), the size-n1 transforms batched over
    (k2, M).  The size-m recursion of tpu_ec's ``_rec`` is this loop.  The
    last GEMM's raw columns go to the final K2; a chunked transform runs
    that GEMM in slices of M, each a block of rows of the operand, followed
    by K2 with T = 2^288, and the final K2 reads their int8 digits."""
    spec = dom.spec
    A, inter = consts["A"], consts["inter"]
    d_in, plan = dom.d_in, dom.plan
    total = (1 << dom.log_n) * M
    chunked = total >= dom.chunk_min
    log_m = dom.log_n
    xk = first(1 << plan[0], 1 << (log_m - plan[0]))
    device = xk.device
    for i, log_n2 in enumerate(plan[:-1]):
        log_n1 = log_m - log_n2
        n1, n2 = 1 << log_n1, 1 << log_n2
        n2p, n1p = 1 << plan[i + 1], 1 << (log_n1 - plan[i + 1])
        T = inter[(log_m, log_n1)]
        if chunked or isinstance(T, dict):
            nxt, region = _leaf_rhs(n1p * n2 * M, n2p * d_in, device)
            with phase("ntt/chunked_level"):
                _chunked_level(dom, A[log_n2], xk, T, n1, n2, M, region.view(n1p, n2, M, n2p, d_in))
            del xk
        else:
            with phase("ntt/leaf_mm"):
                cols = _leaf_mm(A[log_n2], xk, n1 * M)  # (d_out * n2, n1 * M)
            del xk
            with phase("ntt/inter_twiddle"):
                y = inter_twiddle(spec, cols.view(-1, total), T.view(n2 * n1, -1), t_rep=M)
            del cols
            with phase("ntt/transpose"):
                nxt, region = _leaf_rhs(n1p * n2 * M, n2p * d_in, device)
                dst = region.view(n1p, n2, M, n2p, d_in)
                # in slices of k2 of at most _COPY_BYTES, each copy's word transpose a temporary of its size
                c = n2 >> min(log_n2, ((y.numel() - 1) // _COPY_BYTES).bit_length())
                for a in range(0, n2, c):
                    _to_kmajor(y.view(d_in, n2, -1)[:, a : a + c], (c, n2p, n1p, M), (2, 0, 3, 1), dst[:, a : a + c])
            del y, dst
        xk = nxt
        del nxt, region  # xk alone holds the operand, so the final pass frees it
        log_m, M = log_n1, n2 * M
    m = 1 << log_m
    if chunked:
        nc = min(dom.chunk_count, M)
        mc = M // nc
        out = torch.empty((d_in, m, M), dtype=torch.int8, device=device)
        for ci in range(nc):
            s = slice(ci * mc, (ci + 1) * mc)
            with phase("ntt/leaf_mm"):
                cols = _leaf_mm(A[log_m], xk[s], mc)
            with phase("ntt/inter_twiddle"):
                dig = inter_twiddle(spec, cols.view(-1, m * mc), consts["c288"], const_t=True)
            del cols
            out[:, :, s] = dig.view(d_in, m, mc)
        del xk
    else:
        with phase("ntt/leaf_mm"):
            out = _leaf_mm(A[log_m], xk, M)  # (d_out * m, M)
        del xk
    with phase("ntt/inter_twiddle"):
        return inter_twiddle(spec, out.view(-1, total), consts["final_c"], canonical=True, const_t=True,
                             out_rows=out_rows)


def _prepare(spec: FieldSpec, n: int, inverse: bool, leaf: int | None, consts: dict | None, device):
    """(domain, its tables on ``device``) of a transform of n."""
    log_n = int(n).bit_length() - 1
    if 1 << log_n != n:
        raise ValueError("FFT size must be a power of two")
    leaf = leaf_log(log_n) if leaf is None else min(leaf, log_n)
    dom = get_digit_domain(spec, log_n, inverse, leaf)
    return dom, digit_consts(dom, device) if consts is None else consts


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
    return digit_ntt_planes_batch(spec, xp.view(L16, n, 1), inverse, leaf=leaf, consts=consts).view(L16, n)


def digit_ntt_rows(
    spec: FieldSpec,
    x: torch.Tensor,  # (n, L16) half-limb rows, Montgomery form
    inverse: bool = False,
    *,
    leaf: int | None = None,
    consts: dict | None = None,
) -> torch.Tensor:
    """``digit_ntt_planes`` on (n, L16) rows, FftKernel's layout: the digits
    are split from a block of rows at a time and K2 writes the (n, L16)
    canonical rows, so no transposed copy of the whole input or output is
    made."""
    n = x.shape[0]
    dom, consts = _prepare(spec, n, inverse, leaf, consts, x.device)

    def first(n2, n1):
        with phase("ntt/split_rows"):
            xk, region = _leaf_rhs(n1, n2 * dom.d_in, x.device)
            _split_first(x.view(n2, n1, 1, -1).permute(3, 0, 1, 2), region.view(n1, 1, n2, dom.d_in), dom.d_in)
            return xk

    return _transform(dom, consts, first, 1, out_rows=True)


def digit_ntt_planes_batch(
    spec: FieldSpec,
    xpb: torch.Tensor,  # (L16, n, B) half-limb planes, Montgomery form
    inverse: bool = False,
    *,
    leaf: int | None = None,
    consts: dict | None = None,
) -> torch.Tensor:
    """B independent length-n NTTs sharing the single transform's tables:
    the same dataflow with the batch axis M = B threaded through every leaf
    GEMM and K2 pass (tpu_ec's ``digit_ntt_planes_batch``, the local stage of
    a four-step distributed NTT).  Returns (L16, n, B) canonical Montgomery
    planes (< p); ``inverse`` folds n^-1 into the final constant of each
    transform, as ``digit_ntt_planes`` does."""
    L16, n, B = xpb.shape
    dom, consts = _prepare(spec, n, inverse, leaf, consts, xpb.device)

    def first(n2, n1):
        with phase("ntt/split_digits"):
            xk, region = _leaf_rhs(n1 * B, n2 * dom.d_in, xpb.device)
            _split_first(xpb.view(L16, n2, n1, B), region.view(n1, B, n2, dom.d_in), dom.d_in)
            return xk

    return _transform(dom, consts, first, B).view(L16, n, B)
