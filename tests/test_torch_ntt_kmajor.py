"""The digit NTT's K-major leaf GEMM operand (``ops/ntt_digit.py``) against
the row-major (K, N) operand it replaces, built here the old way: the
transpose of K2's digit planes and ``permute(1, 0, 2)``.  Bit for bit, at
every level boundary of the 2^12 .. 2^14 plans at leaf 2^4, whole and in
the slices of a chunked level, and for the first level made from limb rows
and from limb planes (``_split_first``).  Inputs are seeded; tolerance:
none (integers).
"""

import gc
import weakref

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.ops import ntt_digit as tnd

D = 37  # digits of a 256-bit input
LEAF = 4


def _digits(shape, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 128, shape, generator=g, dtype=torch.int8)


def _old_operand(x):
    """The row-major operand of x (d, m, N) planes: (m * d, N), K = (j2, d)."""
    d, m, N = x.shape
    return x.permute(1, 0, 2).reshape(m * d, N)


def _boundaries():
    """(log_n, level, n2, n1, M, n2', n1') of every level boundary of the
    plans of 2^12 .. 2^14 at leaf 2^4."""
    out = []
    for log_n in (12, 13, 14):
        plan = tnd.DigitDomain._plan(log_n, LEAF)
        log_m, M = log_n, 1
        for i, log_n2 in enumerate(plan[:-1]):
            log_n1 = log_m - log_n2
            out.append((log_n, i, 1 << log_n2, 1 << log_n1, M, 1 << plan[i + 1], 1 << (log_n1 - plan[i + 1])))
            log_m, M = log_n1, (1 << log_n2) * M
    return out


@pytest.mark.parametrize("slices", [1, 4, 16], ids=["whole", "4_slices", "16_slices"])
@pytest.mark.parametrize("log_n,level,n2,n1,M,n2p,n1p", _boundaries())
def test_level_operand_matches_the_row_major_one(log_n, level, n2, n1, M, n2p, n1p, slices):
    y = _digits((D, n2, n1 * M), 100 * log_n + level)  # K2's planes (d, k2, (j1, M))
    old = y.view(D, n2, n1, M).transpose(1, 2).contiguous().view(D, n1, n2 * M)
    want = _old_operand(old.view(D, n2p, n1p * n2 * M))
    xk, region = tnd._leaf_rhs(n1p * n2 * M, n2p * D, torch.device("cpu"))
    nxt = region.view(n1p, n2, M, n2p, D)
    c = max(1, n2 // slices)  # the level's min(chunk count, n2) slices
    for a in range(0, n2, c):  # a chunked level writes each slice of k2 from its own K2 output
        y_c = y[:, a : a + c].contiguous()
        tnd._to_kmajor(y_c, (c, n2p, n1p, M), (2, 0, 3, 1), nxt[:, a : a + c])
    assert xk.shape == (n1p * n2 * M, n2p * D) and xk.is_contiguous()
    assert torch.equal(xk.t(), want)


def _limbs(shape, seed):
    """Half-limb values < 2^16 (the CPU's storage dtype)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randint(0, 1 << 16, shape, generator=g, dtype=torch.int64)


@pytest.mark.parametrize("block", [1 << 8, 1 << 22], ids=["many_blocks", "one_block"])
@pytest.mark.parametrize("log_n", [12, 13, 14])
def test_first_operand_from_rows(log_n, block):
    n = 1 << log_n
    n2 = 1 << tnd.DigitDomain._plan(log_n, LEAF)[0]
    n1 = n // n2
    x = _limbs((n, 16), log_n)  # (n, L16) rows
    want = _old_operand(tnd.split_digits_rows(x.T.contiguous(), D).view(D, n2, n1))
    xk, region = tnd._leaf_rhs(n1, n2 * D, torch.device("cpu"))
    tnd._split_first(x.view(n2, n1, 1, 16).permute(3, 0, 1, 2), region.view(n1, 1, n2, D), D, block=block)
    assert torch.equal(xk.t(), want)


@pytest.mark.parametrize("B", [1, 2, 3, 8])
@pytest.mark.parametrize("block", [1 << 8, 1 << 22], ids=["many_blocks", "one_block"])
@pytest.mark.parametrize("log_n", [12, 14])
def test_first_operand_from_planes(log_n, block, B):
    n = 1 << log_n
    n2 = 1 << tnd.DigitDomain._plan(log_n, LEAF)[0]
    n1 = n // n2
    xpb = _limbs((16, n, B), log_n + B)  # (L16, n, B) planes
    want = _old_operand(tnd.split_digits_rows(xpb, D).view(D, n2, n1 * B))
    xk, region = tnd._leaf_rhs(n1 * B, n2 * D, torch.device("cpu"))
    tnd._split_first(xpb.view(16, n2, n1, B), region.view(n1, B, n2, D), D, block=block)
    assert torch.equal(xk.t(), want)


@pytest.mark.parametrize("inner", [1, 2, 3, 4, 8, 24])
def test_to_kmajor_every_word_size(inner):
    """Words of 8, 4 and 2 digits where the innermost axis allows, bytes
    otherwise; size-1 axes dropped."""
    y = _digits((D, 4, 1, 6, inner), inner)
    out = torch.empty((6, 4, 1, inner, D), dtype=torch.int8)
    tnd._to_kmajor(y, (4, 1, 6, inner), (2, 0, 1, 3), out)
    assert torch.equal(out, y.permute(3, 1, 2, 4, 0))


@pytest.mark.parametrize("log_n", [10, 12])
def test_every_leaf_gemm_reads_a_k_major_operand(log_n):
    """The counter of leaf GEMMs by operand layout: a transform of plan
    length k adds k to ``k_major`` and nothing to ``n_major``."""
    spec = tfp.BLS12_381_FR
    x = _limbs((1 << log_n, 16), 5)
    x[:, -1] = 0  # < p
    before = tnd.leaf_mm_counts()
    tnd.digit_ntt_rows(spec, x, leaf=LEAF)
    after = tnd.leaf_mm_counts()
    plan = tnd.DigitDomain._plan(log_n, LEAF)
    assert after["k_major"] - before["k_major"] == len(plan)
    assert after["n_major"] == before["n_major"]


@pytest.mark.parametrize("copy_bytes", [1 << 10, 1 << 14])
def test_unchunked_level_copy_in_slices(monkeypatch, copy_bytes):
    """An unchunked level's transposing copy cut into slices of k2 (forced
    by a small ``_COPY_BYTES``) gives the transform of the copy in one."""
    spec = tfp.BLS12_381_FR
    x = _limbs((1 << 12, 16), 6)
    x[:, -1] = 0  # < p
    want = tnd.digit_ntt_rows(spec, x, leaf=LEAF)
    monkeypatch.setattr(tnd, "_COPY_BYTES", copy_bytes)
    assert torch.equal(tnd.digit_ntt_rows(spec, x, leaf=LEAF), want)


@pytest.mark.parametrize("chunk_min", [1 << 12, 1 << 27], ids=["chunked", "unchunked"])
def test_every_operand_is_freed_before_the_final_pass(monkeypatch, chunk_min):
    """No level's K-major operand outlives the last GEMM: at the final K2
    (which writes the whole output) none is referenced any more, so the
    transform's peak holds no 4.6 GiB operand beside the output at 2^27."""
    monkeypatch.setattr(tnd, "_CHUNK_MIN", chunk_min)
    operands, alive = [], []
    real_mm, real_k2 = tnd._leaf_mm, tnd.inter_twiddle

    def leaf_mm(A2, xk, N):
        base = xk if xk._base is None else xk._base
        if not any(r() is base for r in operands):
            operands.append(weakref.ref(base))
        return real_mm(A2, xk, N)

    def k2(*args, **kw):
        if kw.get("canonical"):  # the final pass
            gc.collect()
            alive.append(sum(r() is not None for r in operands))
        return real_k2(*args, **kw)

    monkeypatch.setattr(tnd, "_leaf_mm", leaf_mm)
    monkeypatch.setattr(tnd, "inter_twiddle", k2)
    x = _limbs((1 << 12, 16), 7)
    x[:, -1] = 0  # < p
    tnd.digit_ntt_rows(tfp.BLS12_381_FR, x, leaf=LEAF)
    assert len(operands) == len(tnd.DigitDomain._plan(12, LEAF)) and alive == [0]
