"""The CUDA kernels against their plain versions, on the card.

Every test here needs a CUDA device and skips without one.  The file
imports no JAX, so it also runs where jax is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda.py

(``--noconftest``: tests/conftest.py sets up JAX.)  Inputs come from
numpy seeds; tolerance: none (integers).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from tpu_ec_torch.curves import BLS12_381_G1, PointOps
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.kernels.inter import inter_twiddle, inter_twiddle_plain
from tpu_ec_torch.kernels.mont import mont_mul, mont_mul_plain
from tpu_ec_torch.kernels.point import point_op, point_op_plain
from tpu_ec_torch.kernels import affine as kaff
from tpu_ec_torch.kernels.butterfly import pease_stage, pease_stage_plain, pease_stages, pease_stages_plain
from tpu_ec_torch.kernels.ntt_leaf import ntt_leaf, ntt_leaf_plain

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _field(spec, n, seed):
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 1 << 16, (n, spec.n_limbs), dtype=np.int64)
    a[:, -1] = rng.integers(0, int(spec.p_limbs[-1]), n)  # < p
    a[:2] = 0
    a[1, 0] = 1
    a[2] = [((spec.modulus - 1) >> (16 * i)) & 0xFFFF for i in range(spec.n_limbs)]
    return a


@pytest.mark.parametrize("name", ["BLS12_381_FR", "BLS12_381_FQ", "BN254_FR", "BN254_FQ"])
def test_mont_kernel_matches_plain(cuda, name):
    spec = getattr(tfp, name)
    a = torch.as_tensor(_field(spec, 4099, 1)).to(cuda, torch.int32)
    b = torch.as_tensor(_field(spec, 4099, 2)[::-1].copy()).to(cuda, torch.int32)
    assert torch.equal(mont_mul(spec, a, b), mont_mul_plain(spec, a, b))
    one = b[1]  # broadcast operand: the from_mont shape
    assert torch.equal(mont_mul(spec, a, one), mont_mul_plain(spec, a, one))


@pytest.mark.parametrize("canonical,const_t", [(False, False), (True, True), (True, False)])
def test_inter_kernel_matches_plain(cuda, canonical, const_t):
    spec = tfp.BLS12_381_FR
    rng = np.random.default_rng(3)
    n = 3001
    cols = torch.as_tensor(rng.integers(0, (1 << 7) * 37 * 127 * 127, (37, n))).to(cuda, torch.int32)
    t = _field(spec, n, 4)
    t16 = torch.as_tensor(t[7] if const_t else t).to(cuda, torch.int32).contiguous()
    kw = dict(canonical=canonical, const_t=const_t)
    assert torch.equal(inter_twiddle(spec, cols, t16, **kw), inter_twiddle_plain(spec, cols, t16, **kw))


@pytest.mark.parametrize("canonical", [False, True], ids=["to_int8", "canonical"])
def test_inter_int8_entry_matches_plain(cuda, canonical):
    """K2's int8-digit entry (the final pass after a chunked last GEMM),
    with the constant twiddle, and canonical rows out as FftKernel takes
    them."""
    from tpu_ec_torch.kernels import inter as kinter

    spec = tfp.BLS12_381_FR
    rng = np.random.default_rng(5)
    n = 4099
    dig = torch.as_tensor(rng.integers(0, 128, (37, n))).to(cuda, torch.int8)
    dig[:, 0] = 127
    t16 = torch.as_tensor(_field(spec, 8, 6)[3]).to(cuda, torch.int32)
    kw = dict(canonical=canonical, const_t=True)
    before = (kinter.LAUNCHES.count, kinter.LAUNCHES_I8.count)
    assert torch.equal(inter_twiddle(spec, dig, t16, **kw), inter_twiddle_plain(spec, dig, t16, **kw))
    assert (kinter.LAUNCHES.count, kinter.LAUNCHES_I8.count) == (before[0], before[1] + 1)
    if canonical:
        got = inter_twiddle(spec, dig, t16, out_rows=True, **kw)
        assert torch.equal(got, inter_twiddle_plain(spec, dig, t16, **kw).T)


@pytest.mark.parametrize("t_rep", [1, 8])
def test_inter_kernel_twiddle_rows_and_repeat(cuda, t_rep):
    """K2 reading (nt, 16) twiddle rows (K1's layout), column i's twiddle at
    row i // t_rep, as a four-step level over a batch M = t_rep reads its
    table."""
    spec = tfp.BLS12_381_FR
    rng = np.random.default_rng(7)
    n = 8 * 512
    cols = torch.as_tensor(rng.integers(0, (1 << 8) * 37 * 127 * 127, (40, n))).to(cuda, torch.int32)
    t16 = torch.as_tensor(_field(spec, n // t_rep, 8)).to(cuda, torch.int32)
    want = inter_twiddle_plain(spec, cols, t16.repeat_interleave(t_rep, dim=0))
    assert torch.equal(inter_twiddle(spec, cols, t16, t_rep=t_rep), want)
    assert torch.equal(inter_twiddle_plain(spec, cols, t16, t_rep=t_rep), want)


def test_mont_kernel_trailing_operand_and_out(cuda):
    """K1 with b one row block repeated along a (the table doubling's
    operand), written into a slice of a larger tensor."""
    spec = tfp.BLS12_381_FR
    a = torch.as_tensor(_field(spec, 6 * 1024, 9)).to(cuda, torch.int32).view(6, 1024, 16)
    b = torch.as_tensor(_field(spec, 1024, 10)).to(cuda, torch.int32)
    big = torch.zeros((8, 1024, 16), dtype=torch.int32, device=cuda)
    mont_mul(spec, a, b, out=big[2:])
    assert torch.equal(big[2:], mont_mul_plain(spec, a, b))
    assert not big[:2].any()


def test_device_table_matches_host_table(cuda):
    """The Bailey table built on the card with K1 at 2^16 (the level-0 table
    of a 2^16 transform, n2 = 2^6, n1 = 2^10) against the host table."""
    from tpu_ec_torch.ops.ntt import get_domain
    from tpu_ec_torch.ops.ntt_digit import inter_table288_device, inter_table288_np

    spec = tfp.BLS12_381_FR
    for inverse in (False, True):
        omega = get_domain(spec, 16, inverse).omega
        got = inter_table288_device(spec, omega, 16, 16, 10, cuda)
        want = inter_table288_np(spec, omega, 16, 16, 10)
        assert np.array_equal(got.permute(2, 0, 1).cpu().numpy(), want.astype(np.int32))


def test_chunked_route_matches_unchunked(cuda, monkeypatch):
    """FftKernel at 2^20 with the chunked route forced (factored seeds at the
    2^20 level, K2's int8 entry in the final pass) against the default
    route, both directions."""
    from tpu_ec_torch.kernels import inter as kinter
    from tpu_ec_torch.ops import ntt_digit
    from tpu_ec_torch.ops.ntt import FftKernel

    spec = tfp.BLS12_381_FR
    x = torch.as_tensor(_field(spec, 1 << 20, 14)).to(cuda, torch.int32)
    want = [FftKernel(spec, cuda).radix_fft(x, inverse=inv) for inv in (False, True)]
    monkeypatch.setattr(ntt_digit, "_CHUNK_MIN", 1 << 20)
    k = FftKernel(spec, cuda)
    before = kinter.LAUNCHES_I8.count
    for inv, w in zip((False, True), want):
        assert torch.equal(k.radix_fft(x, inverse=inv), w)
    assert kinter.LAUNCHES_I8.count == before + 2
    assert ntt_digit.get_digit_domain(spec, 20, False, 8).inter[(20, 13)] == "factored"


def _points(ops, n):
    """k*G for k = 1..n (affine), and Jacobian forms with z != 1."""
    g = ops.from_affine_ints([(ops.spec.gen_x, ops.spec.gen_y)])
    acc = [ops.to_jacobian(g)]
    for _ in range(n - 1):
        acc.append(ops.add_mixed(acc[-1], g))
    jac = tuple(torch.cat(c) for c in zip(*acc))
    return ops.to_affine(jac), ops.double(jac)


def _point_rows(ops, n=40):
    """P, Q (Jacobian) and A (affine) with the select tree's rows: 0 P =
    identity, 1 Q = A = identity, 2 Q == P and A == P, 3 Q == -P and
    A == -P, 4 both identity, 5 coordinates 0 and p - 1 (no curve point;
    on G2 p - 1 in both components)."""
    A, P = _points(ops, n)
    A2, Q = _points(ops, n + 1)
    A2 = [c[1:].clone() for c in A2]
    Q = [c[1:].clone() for c in Q]
    P = [c.clone() for c in P]
    PA = ops.to_affine(tuple(c[2:4] for c in P))
    for c in P:
        c[0] = 0
        c[4] = 0
    for c in Q:
        c[1] = 0
        c[4] = 0
    for c in A2:
        c[1] = 0
        c[4] = 0
    for k in range(3):
        Q[k][2] = P[k][2]
    for k in range(2):
        A2[k][2] = PA[k][0]
    Q[1][3] = ops.F.neg(P[1][3:4])[0]
    Q[0][3], Q[2][3] = P[0][3], P[2][3]
    A2[0][3] = PA[0][1]
    A2[1][3] = ops.F.neg(PA[1][1:2])[0]
    pm1 = torch.tensor([((ops.spec.base.modulus - 1) >> (16 * i)) & 0xFFFF for i in range(ops.L)] * ops.spec.ext,
                       dtype=torch.int32, device=P[0].device)
    P[0][5], P[1][5], P[2][5] = pm1, 0, pm1
    Q[0][5], Q[1][5], Q[2][5] = 0, pm1, pm1
    A2[0][5], A2[1][5] = pm1, pm1
    return P, Q, A2


@pytest.mark.parametrize("curve", ["BLS12_381_G1", "BN254_G1"])
def test_point_kernel_matches_plain(cuda, curve):
    from tpu_ec_torch import curves

    spec = getattr(curves, curve)
    ops = PointOps(spec, cuda)
    P, Q, A = _point_rows(ops)
    for op, ins in (("add", [*P, *Q]), ("add_mixed", [*P, *A]), ("double", [*P]),
                    ("add_mixed", [*P[:2], *A])):  # affine P, lifted
        got, want = point_op(spec.base, op, ins), point_op_plain(spec.base, op, ins)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (op, len(ins))


@pytest.mark.parametrize("op", ["add", "add_mixed"])
def test_point_kernel_keep_and_out(cuda, op):
    """keep + out= (the pair MSM's fused rows) == where(keep, P, P + Q)
    written into separate outputs."""
    ops = PointOps(BLS12_381_G1, cuda)
    P, Q, A = _point_rows(ops)
    ins = [*P, *Q] if op == "add" else [*P[:2], *A]
    n, L = P[0].shape[0], ops.L
    keep = torch.zeros(n, dtype=torch.bool, device=cuda)
    keep[::3] = True
    fused = torch.full((n, 3 * L), -1, dtype=torch.int32, device=cuda)
    got = point_op(BLS12_381_G1.base, op, ins, keep=keep, out=fused)
    plain = point_op_plain(BLS12_381_G1.base, op, ins, keep)
    Pj = ins[:3] if op == "add" else ops.to_jacobian(tuple(ins[:2]))
    want = tuple(torch.where(keep.unsqueeze(-1), p, r) for p, r in zip(Pj, point_op(BLS12_381_G1.base, op, ins)))
    assert all(torch.equal(g, w) and torch.equal(g, q) for g, w, q in zip(got, want, plain))
    assert torch.equal(fused, torch.cat(want, dim=1))


def test_point_kernel_row_strides(cuda):
    """Column slices of one fused row matrix (the MSM's layout) give the
    same result as contiguous coordinates."""
    ops = PointOps(BLS12_381_G1, cuda)
    _, P = _points(ops, 16)
    fused = torch.cat(P, dim=1)  # (16, 72)
    views = [fused[:, i * 24 : (i + 1) * 24] for i in range(3)]
    got = point_op(BLS12_381_G1.base, "double", views)
    want = point_op(BLS12_381_G1.base, "double", [v.contiguous() for v in views])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_point_kernel_unaligned_rows(cuda):
    """Rows that are not 16-byte aligned take the kernel's scalar loads and
    stores and give the same result."""
    ops = PointOps(BLS12_381_G1, cuda)
    P, Q, _ = _point_rows(ops)
    n, L = P[0].shape[0], ops.L
    src = torch.zeros((n, 6 * L + 1), dtype=torch.int32, device=cuda)
    for k, c in enumerate([*P, *Q]):
        src[:, 1 + k * L : 1 + (k + 1) * L] = c
    views = [src[:, 1 + k * L : 1 + (k + 1) * L] for k in range(6)]
    dst = torch.zeros((n, 3 * L + 1), dtype=torch.int32, device=cuda)
    got = point_op(BLS12_381_G1.base, "add", views, out=dst[:, 1:])
    want = point_op_plain(BLS12_381_G1.base, "add", [*P, *Q])
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def _horner_edge_sums(ops, C, w, kinds):
    """(4, C, L) window sums of K3's Horner with one edge a chunk, chunk c
    taking kinds[c % len(kinds)]: "same" (the second window's sum equals the
    running result 2^w P: the add's P == Q branch), "cancel" (it equals
    -2^w P), "garbage" (identities with z = 0 and x, y != 0 in the top and a
    middle window), "zero" (every window the identity), "top" (the top two
    windows the identity: the kernel skips their doublings), "random"."""
    Wn = 4
    _, P = _points(ops, 24)
    idx = (torch.arange(Wn, device=P[0].device)[:, None] * 5
           + torch.arange(C, device=P[0].device)[None, :] * 3) % 24
    S = [c[idx].clone() for c in P]  # (Wn, C, L)
    for c in range(C):
        kind = kinds[c % len(kinds)]
        top = tuple(x[Wn - 1, c : c + 1] for x in S)
        if kind in ("same", "cancel"):
            q = top
            for _ in range(w):
                q = ops.double(q)
            if kind == "cancel":
                q = (q[0], ops.F.neg(q[1]), q[2])
            for x, v in zip(S, q):
                x[Wn - 2, c] = v[0]
        elif kind == "garbage":
            for j in (Wn - 1, 1):
                S[2][j, c] = 0
        elif kind == "zero":
            for x in S:
                x[:, c] = 0
        elif kind == "top":
            for x in S:
                x[Wn - 2 :, c] = 0
    return S


@pytest.mark.parametrize("curve", ["BLS12_381_G1", "BN254_G1"])
def test_horner_kernel_matches_loop(cuda, curve):
    """One Horner launch (one tile of lanes a chunk) == the loop of batched
    doubles and adds: with an identity window, for w > 0 and w = 0; then
    with every edge of _horner_edge_sums, at C = 1, 2, 7, 9 (the last warp
    not full) and 1025, w = 0, 1, 7, 14."""
    from tpu_ec_torch import curves
    from tpu_ec_torch.kernels.point import horner, horner_plain

    spec = getattr(curves, curve)
    ops = PointOps(spec, cuda)
    _, P = _points(ops, 7)
    S = [c.clone() for c in P]
    for c in S:
        c[3] = 0
    for w in (4, 0):
        got = horner(spec.base, S, w)
        assert all(torch.equal(g, h) for g, h in zip(got, horner_plain(spec.base, S, w))), w
    kinds = ("same", "cancel", "garbage", "zero", "top", "random")
    for w in (0, 1, 7, 14):
        for C in (1, 2, 7, 9, 1025):
            for first in range(len(kinds) if C == 1 else 1):  # C = 1: each edge in turn
                S = _horner_edge_sums(ops, C, w, kinds[first:] + kinds[:first])
                got = horner(spec.base, S, w)
                assert got[0].shape == (C, ops.L)
                want = horner_plain(spec.base, S, w)
                assert all(torch.equal(g, h) for g, h in zip(got, want)), (w, C, first)


def test_commit_matches_native(cuda):
    from tpu_ec_torch.native import native_curve, native_field
    from tpu_ec_torch.ops.pipeline import CommitPipeline

    n = 1 << 12
    nc, nfr = native_curve(BLS12_381_G1), native_field(BLS12_381_G1.scalar)
    rng = np.random.default_rng(5)
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    G = nc.affine_from_points([(BLS12_381_G1.gen_x, BLS12_381_G1.gen_y)])
    aff = nc.to_affine(nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks))
    w = nc.w
    bases = tuple(
        torch.as_tensor(nc.fq.to_halflimbs(aff[:, i * w : (i + 1) * w]).astype(np.int64)).to(cuda, torch.int32)
        for i in range(2)
    )
    coeffs = _field(BLS12_381_G1.scalar, n, 6)
    evals, commit = CommitPipeline(BLS12_381_G1, cuda).commit(torch.as_tensor(coeffs).to(cuda, torch.int32), bases)
    want_evals = nfr.ntt(nfr.from_halflimbs(coeffs.astype(np.uint64)))
    assert np.array_equal(nfr.from_halflimbs(evals.cpu().numpy().astype(np.uint64)), want_evals)
    x, y = PointOps(BLS12_381_G1, cuda).to_affine(commit)
    got = np.concatenate([nc.fq.from_halflimbs(c.cpu().numpy().astype(np.uint64)) for c in (x, y)], axis=1)
    want = nc.to_affine(nc.msm(aff, nfr.from_mont(want_evals))[None, :])
    assert np.array_equal(got, want)


def test_pease_stage_kernel_matches_plain(cuda):
    spec = tfp.BLS12_381_FR
    y = torch.as_tensor(_field(spec, 5 * 512, 7).reshape(5, 512, 16)).to(cuda, torch.int32)
    tw = torch.as_tensor(_field(spec, 256, 8)).to(cuda, torch.int32)
    for s in (0, 3, 8):
        assert torch.equal(pease_stage(spec, y, tw, s), pease_stage_plain(spec, y, tw, s)), s


@pytest.mark.parametrize("name", ["BLS12_381_FR", "BLS12_381_FQ"])
@pytest.mark.parametrize("log_n", [1, 2, 3, 5, 6, 8, 9, 10, 12])
def test_pease_stages_kernel_matches_plain(cuda, name, log_n):
    """Stage ranges of the multi-stage K5 entry, with and without the bit
    reversal, on batches whose last block is ragged (512 / n rows a block
    below n = 512); 2^12 rows run one launch a stage."""
    from tpu_ec_torch import kernels

    spec = getattr(tfp, name)
    n, L = 1 << log_n, spec.n_limbs
    batch = max(3, 3 * 512 // n + 1)
    y = torch.as_tensor(_field(spec, batch * n, 20 + log_n).reshape(batch, n, L)).to(cuda, torch.int32)
    tw = torch.as_tensor(_field(spec, max(3, n // 2), 21)[: n // 2]).to(cuda, torch.int32)
    ranges = {(0, log_n, True), (0, 1, False), (log_n - 1, log_n, True), (log_n // 2, log_n, False)}
    for s0, s1, bitrev in sorted(ranges):
        kernels.reset_launch_counters()
        got = pease_stages(spec, y, tw, s0, s1, bitrev)
        launches = kernels.launch_counters()["pease_stage"]
        assert torch.equal(got, pease_stages_plain(spec, y, tw, s0, s1, bitrev)), (s0, s1, bitrev)
        assert launches == (1 if log_n <= 10 else s1 - s0), (s0, s1, launches)


@pytest.mark.parametrize("log_m,batch", [(1, 300), (2, 257), (3, 129), (4, 4096), (5, 33), (8, 33),
                                         (9, 7), (10, 5)])
def test_ntt_leaf_kernel_matches_plain(cuda, log_m, batch):
    spec = tfp.BLS12_381_FR
    m = 1 << log_m
    x = torch.as_tensor(_field(spec, m * batch, 9).reshape(m, batch, 16)).to(cuda, torch.int32)
    k = log_m * (m // 2)
    tw = torch.as_tensor(_field(spec, max(k, 3), 10)[:k].reshape(log_m, m // 2, 16)).to(cuda, torch.int32)
    assert torch.equal(ntt_leaf(spec, x, tw), ntt_leaf_plain(spec, x, tw))


@pytest.mark.parametrize("name", ["BLS12_381_FR", "BLS12_381_FQ"])
@pytest.mark.parametrize("log_m,batch,B", [(1, 600, 2), (2, 300, 3), (3, 128, 1), (4, 192, 64),
                                           (4, 300, 3), (5, 40, 5), (7, 12, 2), (8, 12, 3), (8, 64, 1),
                                           (8, 32, 16), (9, 6, 1), (10, 3, 1), (10, 6, 2)])
def test_ntt_leaf_level_kernel_matches_plain(cuda, name, log_m, batch, B):
    """K4 with the level epilogue (times T, transposed to (n1, m * B)) on
    column counts the block's C columns do not divide, B above and below C."""
    spec = getattr(tfp, name)
    m, L = 1 << log_m, spec.n_limbs
    x = torch.as_tensor(_field(spec, m * batch, 30 + log_m).reshape(m, batch, L)).to(cuda, torch.int32)
    k = log_m * (m // 2)
    tw = torch.as_tensor(_field(spec, max(k, 3), 31)[:k].reshape(log_m, m // 2, L)).to(cuda, torch.int32)
    T = torch.as_tensor(_field(spec, m * (batch // B), 32).reshape(m, batch // B, L)).to(cuda, torch.int32)
    got = ntt_leaf(spec, x, tw, level=(T, B))
    assert got.shape == (batch // B, m * B, L)
    assert torch.equal(got, ntt_leaf_plain(spec, x, tw, level=(T, B)))


def _affine_pairs(ops, n):
    """Affine pairs (k*G, (k+1)*G) with identity, both-identity, P == Q and
    P == -Q rows, as fused (n, 2L) rows and their column slices."""
    A, _ = _points(ops, n + 1)
    P = tuple(c[:n].clone() for c in A)
    Q = tuple(c[1:].clone() for c in A)
    for c in P:
        c[0] = 0
    for c in Q:
        c[1] = 0
        c[0] = 0
    for k in range(2):
        Q[k][2] = P[k][2]
    Q[0][3] = P[0][3]
    Q[1][3] = ops.F.neg(P[1][3:4])[0]
    L = ops.L
    fused = torch.cat([*P, *Q], dim=1)
    return [fused[:, i * L : (i + 1) * L] for i in range(4)]


def _affine_apply_edges(cuda, spec):
    """K7's apply half (a warp moving its 32 pairs' rows) against its plain
    version at n = 1, 127, 129 and 2^16 + 3 (ragged last warps), on column
    slices of a fused (n, 5L) row matrix (16-byte aligned rows: the staged
    path) and of one shifted by a word (each lane's own loads), with rows of
    every flag at both ends: iz1, iz2, both, the tangent, the cancel, the
    order-2 tangent (x1 == x2, y1 == y2 == 0) and a chord with y1 = 0."""
    L = spec.n_limbs
    pm = [((spec.modulus - 1) >> (16 * i)) & 0xFFFF for i in range(L)]
    for n in (1, 127, 129, (1 << 16) + 3):
        c = [torch.as_tensor(_field(spec, max(n, 3), 60 + k)[:n]).to(cuda, torch.int32) for k in range(5)]
        x1, y1, x2, y2, iv = c
        for r in sorted({0, 7, n - 7} & set(range(0, max(n - 6, 1)))):
            rows = list(range(r, min(r + 7, n)))
            edits = [("iz1",), ("iz2",), ("iz1", "iz2"), ("same",), ("cancel",), ("y1z", "same"), ("y1z",)]
            for i, e in zip(rows, edits):
                if "iz1" in e:
                    x1[i] = y1[i] = 0
                if "iz2" in e:
                    x2[i] = y2[i] = 0
                if "y1z" in e:
                    y1[i] = 0
                if "same" in e:
                    x2[i], y2[i] = x1[i], y1[i]
                if "cancel" in e:
                    x2[i] = x1[i]
                    y2[i] = torch.tensor(pm, dtype=torch.int32, device=cuda)  # p - 1 != y1
        want = kaff.affine_apply_plain(spec, x1, y1, x2, y2, iv)
        for shift in (0, 1):
            fused = torch.zeros((n, 5 * L + shift), dtype=torch.int32, device=cuda)
            for k, t in enumerate(c):
                fused[:, shift + k * L : shift + (k + 1) * L] = t
            views = [fused[:, shift + k * L : shift + (k + 1) * L] for k in range(5)]
            got = kaff.affine_apply(spec, *views)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (n, shift)


def test_affine_kernels_match_plain(cuda):
    ops = PointOps(BLS12_381_G1, cuda)
    spec = BLS12_381_G1.base
    x1, y1, x2, y2 = _affine_pairs(ops, 40)
    d = kaff.affine_denom(spec, x1, y1, x2, y2)
    assert torch.equal(d, kaff.affine_denom_plain(spec, x1, y1, x2, y2))
    got = kaff.affine_apply(spec, x1, y1, x2, y2, d)
    want = kaff.affine_apply_plain(spec, x1, y1, x2, y2, d)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    # co-Z: two windows of 20 rows, each with its own r2, r3
    win = [c.reshape(2, 20, ops.L) for c in (x1, y1, x2, y2, d)]
    r = d[5:7].reshape(2, 1, ops.L).contiguous()
    r3 = d[7:9].reshape(2, 1, ops.L).contiguous()
    got = kaff.coz_apply(spec, *win, r, r3)
    want = kaff.coz_apply_plain(spec, *win, r, r3)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    for field in (spec, tfp.BN254_FQ):
        _affine_apply_edges(cuda, field)


def test_coz_msm_matches_native(cuda):
    from tpu_ec_torch.native import native_curve, native_field
    from tpu_ec_torch.ops.msm import MultiexpKernel

    n = 1 << 12
    nc, nfr = native_curve(BLS12_381_G1), native_field(BLS12_381_G1.scalar)
    rng = np.random.default_rng(11)
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    G = nc.affine_from_points([(BLS12_381_G1.gen_x, BLS12_381_G1.gen_y)])
    aff = nc.to_affine(nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks))
    w = nc.w
    bases = tuple(
        torch.as_tensor(nc.fq.to_halflimbs(aff[:, i * w : (i + 1) * w]).astype(np.int64)).to(cuda, torch.int32)
        for i in range(2)
    )
    scal = _field(BLS12_381_G1.scalar, n, 12)
    kern = MultiexpKernel(BLS12_381_G1, cuda)
    out = kern.multiexp(bases, torch.as_tensor(scal).to(cuda, torch.int32), method="coz")
    x, y = kern.ops.to_affine(out)
    got = np.concatenate([nc.fq.from_halflimbs(c.cpu().numpy().astype(np.uint64)) for c in (x, y)], axis=1)
    want = nc.to_affine(nc.msm(aff, nfr.from_halflimbs(scal.astype(np.uint64)))[None, :])
    assert np.array_equal(got, want)


def test_fused_ntt_matches_digit(cuda):
    from tpu_ec_torch.config import get_config
    from tpu_ec_torch.ops.ntt import FftKernel

    spec = tfp.BLS12_381_FR
    x = torch.as_tensor(_field(spec, 1 << 14, 13)).to(cuda, torch.int32)
    cfg = get_config()
    saved = cfg.ntt_impl
    try:
        want = FftKernel(spec, cuda).radix_fft(x)
        cfg.ntt_impl = "fused"
        k = FftKernel(spec, cuda)
        y = k.radix_fft(x)
        assert torch.equal(y, want)
        assert torch.equal(k.radix_fft(y, inverse=True), x)
    finally:
        cfg.ntt_impl = saved


def test_radix_fft_many_is_one_pease_launch(cuda):
    """The staged NTT of a (B, 2^9) batch: one K5 launch forward, one K5
    and one K1 (n^-1) inverse, equal to the transforms one row at a time."""
    from tpu_ec_torch import kernels
    from tpu_ec_torch.ops.ntt import FftKernel

    spec = tfp.BLS12_381_FR
    xs = torch.as_tensor(_field(spec, 7 * 512, 14).reshape(7, 512, 16)).to(cuda, torch.int32)
    k = FftKernel(spec, cuda)
    kernels.reset_launch_counters()
    y = k.radix_fft_many(xs)
    assert kernels.launch_counters()["pease_stage"] == 1
    kernels.reset_launch_counters()
    back = k.radix_fft_many(y, inverse=True)
    counts = kernels.launch_counters()
    assert (counts["pease_stage"], counts["mont_mul"]) == (1, 1)
    assert torch.equal(back, xs)
    assert all(torch.equal(y[i], k.radix_fft(xs[i])) for i in (0, 6))


@pytest.mark.parametrize("C", [1024, 1])
def test_horner_batch_kernel_matches_plain(cuda, C):
    """K3's batched Horner (one thread a chunk) at the AMT path's (37, 1024)
    shape and at C = 1, on column slices of fused (W, C, 3L) rows as the
    path passes them, with identity sums, against its plain version."""
    from tpu_ec_torch.kernels.point import horner, horner_plain

    ops = PointOps(BLS12_381_G1, cuda)
    _, P = _points(ops, 64)
    W, L = 37, ops.L
    idx = (torch.arange(W, device=cuda)[:, None] * 7 + torch.arange(C, device=cuda)[None, :] * 3) % 64
    fused = torch.cat([c[idx] for c in P], dim=-1)  # (W, C, 3L)
    fused[3, 0] = 0
    fused[5, -1] = 0
    S = [fused[..., k * L : (k + 1) * L] for k in range(3)]
    got = horner(BLS12_381_G1.base, S, 7)
    assert got[0].shape == (C, L)
    assert all(torch.equal(g, w) for g, w in zip(got, horner_plain(BLS12_381_G1.base, S, 7)))


def _batch_inputs(cuda, C, n):
    ops = PointOps(BLS12_381_G1, cuda)
    bases, _ = _points(ops, C * n)
    scal = torch.as_tensor(_field(BLS12_381_G1.scalar, C * n, 15)).to(cuda, torch.int32)
    return bases, scal


def test_multiple_multiexp_matches_cpu(cuda, monkeypatch):
    """multiple_multiexp on the card, flat engine in slabs of two of three
    chunks and the scan engine, equals the CPU path bit for bit."""
    from tpu_ec_torch.config import get_config
    from tpu_ec_torch.ops.msm import MultiexpKernel, batch_slab

    C, n = 3, 32
    bases, scal = _batch_inputs(cuda, C, n)
    budget = 1 << 16
    while batch_slab(BLS12_381_G1, "pair", n, 5, cuda, budget) < 2:
        budget *= 2  # at most doubles the slab, so it stops at 2
    monkeypatch.setattr(get_config(), "msm_hbm_budget_bytes", budget)
    card, cpu = MultiexpKernel(BLS12_381_G1, cuda), MultiexpKernel(BLS12_381_G1, "cpu")
    cpu_in = (tuple(t.cpu().to(torch.int64) for t in bases), scal.cpu().to(torch.int64))
    for method in ("pair", "scan"):
        got = card.multiple_multiexp(bases, scal, C, window_size=5, method=method)
        want = cpu.multiple_multiexp(*cpu_in, C, window_size=5, method=method)
        assert all(torch.equal(g.cpu().to(torch.int64), w) for g, w in zip(got, want)), method


def test_batch_k3_launches_one_slab(cuda):
    """One slab of the flat engine launches K3 once a pair round, once a
    finish round, once a round of the two tails and once for the Horner
    combine, which its own counter counts too."""
    import math

    from tpu_ec_torch import kernels
    from tpu_ec_torch.ops.msm import MultiexpKernel

    C, n, w = 4, 64, 5
    bases, scal = _batch_inputs(cuda, C, n)
    kernels.reset_launch_counters()
    MultiexpKernel(BLS12_381_G1, cuda).multiple_multiexp(bases, scal, C, window_size=w)
    rounds = int(math.log2(C * n))
    want = rounds + max(1, math.ceil(math.log2(rounds + 2))) + 2 * (w - 1) + 1
    counts = kernels.launch_counters()
    assert (counts["point"], counts["point_horner"]) == (want, 1)


def _chain_rows(ops, cuda, n=64):
    """n Jacobian points (z != 1), row 0 the identity, row 1 a garbage
    identity (z = 0, x, y != 0: P - P), and n plain scalars: 0, 1, 2,
    r - 1, r + 2 (its last add meets acc == P), 2^256 - 1, small and
    random values."""
    _, P = _points(ops, n)
    P = [c.clone() for c in P]
    G = ops.sub(tuple(c[1:2] for c in P), tuple(c[1:2] for c in P))
    for c, g in zip(P, G):
        c[0] = 0
        c[1] = g[0]
    r = ops.spec.scalar.modulus
    rng = np.random.default_rng(30)
    ks = [int.from_bytes(rng.bytes(32), "little") for _ in range(n)]
    ks[:8] = [2**256 - 1, r - 1, 0, 1, 2, r - 1, r + 2, 5]
    ks[8:16] = [int(v) for v in rng.integers(0, 1 << 10, 8)]
    k = np.stack([[(v >> (16 * i)) & 0xFFFF for i in range(16)] for v in ks]).astype(np.int64)
    return P, torch.as_tensor(k).to(cuda, torch.int32)


@pytest.mark.parametrize("curve", ["BLS12_381_G1", "BN254_G1"])
def test_scalar_mul_kernel_matches_plain(cuda, curve):
    """K3's chain entry (one tile of lanes a point, at the tile size chain.cu
    fixes for the curve's field; the two shortcuts) == the plain 256-step
    loop, per-row scalars and one scalar for all rows (stride 0)."""
    from tpu_ec_torch import curves
    from tpu_ec_torch.kernels.point import chain_tile, point_scalar_mul, scalar_mul_plain

    spec = getattr(curves, curve)
    assert (spec.base.n_limbs // 2) % chain_tile(spec.base) == 0
    ops = PointOps(spec, cuda)
    P, k = _chain_rows(ops, cuda)
    got = point_scalar_mul(spec.base, P, k)
    assert all(torch.equal(g, w) for g, w in zip(got, scalar_mul_plain(spec.base, P, k)))
    one = k[6]
    got = point_scalar_mul(spec.base, P, one)
    assert all(torch.equal(g, w) for g, w in zip(got, scalar_mul_plain(spec.base, P, one)))


@pytest.mark.parametrize("curve", ["BLS12_381_G1", "BN254_G1"])
def test_ec_fft_stage_kernel_matches_plain(cuda, curve):
    """K3's EC-FFT stage entry == its plain version at every stage of two
    transforms of 64 points, with a == b, a == -b and identity rows: the
    stages below log2(32 / T) put tiles of different scalars in one warp,
    the others one scalar a warp."""
    from tpu_ec_torch import curves
    from tpu_ec_torch.kernels.point import chain_tile, ec_fft_stage, ec_fft_stage_plain
    from tpu_ec_torch.ops.ec_fft import get_ec_domain

    spec = getattr(curves, curve)
    assert 32 // chain_tile(spec.base) < 64  # both kinds of stage occur
    ops = PointOps(spec, cuda)
    _, P = _points(ops, 128)
    Y = [c.reshape(2, 64, -1).clone() for c in P]
    negy = ops.F.neg(Y[1][1, 1:2])[0]
    for c in Y:
        c[0, 32] = c[0, 0]  # a == b
        c[1, 33] = c[1, 1]
        c[1, 2] = 0  # identity
    Y[1][1, 33] = negy  # a == -b
    tw = torch.as_tensor(get_ec_domain(spec, 6).twiddle_scalars.astype(np.int64)).to(cuda, torch.int32)
    for s in range(6):
        got, want = ec_fft_stage(spec.base, Y, tw, s), ec_fft_stage_plain(spec.base, Y, tw, s)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), s
        Y = list(want)


def test_ec_fft_matches_native(cuda):
    """A 2^8 BN254 EC-FFT on the card == the native C++ EC-FFT (affine), its
    inverse gives the points back, one stage launch a stage and one chain
    launch for the inverse's scaling."""
    from tpu_ec_torch import kernels
    from tpu_ec_torch.curves import BN254_G1
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.ec_fft import EcFftKernel

    n = 1 << 8
    nc = native_curve(BN254_G1)
    rng = np.random.default_rng(31)
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    G = nc.affine_from_points([(BN254_G1.gen_x, BN254_G1.gen_y)])
    jac = nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks)
    w = nc.w
    P = tuple(torch.as_tensor(nc.fq.to_halflimbs(jac[:, i * w : (i + 1) * w]).astype(np.int64)).to(cuda, torch.int32)
              for i in range(3))
    kern = EcFftKernel(BN254_G1, cuda)
    kernels.reset_launch_counters()
    out = kern.radix_ec_fft(P)
    counts = kernels.launch_counters()
    assert (counts["ec_fft_stage"], counts["point_scalar_mul"]) == (8, 0)
    got = np.concatenate([nc.fq.from_halflimbs(c.cpu().numpy().astype(np.uint64)) for c in out], axis=1)
    assert np.array_equal(nc.to_affine(got), nc.to_affine(nc.ec_fft(jac)))
    kernels.reset_launch_counters()
    back = kern.radix_ec_fft(out, inverse=True)
    counts = kernels.launch_counters()
    assert (counts["ec_fft_stage"], counts["point_scalar_mul"]) == (8, 1)
    ops = kern.ops
    assert all(torch.equal(a, b) for a, b in zip(ops.to_affine(back), ops.to_affine(P)))


def test_sparse_and_coefficient_commits_match_native(cuda):
    """commit_coefficient_basis and commit_sparse (half density, skip 16) at
    2^12 on the card == the native Pippenger over the same terms."""
    from tpu_ec_torch.native import native_curve, native_field
    from tpu_ec_torch.ops.density import DensityTracker
    from tpu_ec_torch.ops.pipeline import CommitPipeline

    n, skip = 1 << 12, 16
    nc, nfr = native_curve(BLS12_381_G1), native_field(BLS12_381_G1.scalar)
    rng = np.random.default_rng(32)
    ks = np.zeros((n + skip, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n + skip, dtype=np.uint64)
    G = nc.affine_from_points([(BLS12_381_G1.gen_x, BLS12_381_G1.gen_y)])
    aff = nc.to_affine(nc.scalar_mul(np.broadcast_to(G, (n + skip, G.shape[1])).copy(), ks))
    w = nc.w
    bases = tuple(
        torch.as_tensor(nc.fq.to_halflimbs(aff[:, i * w : (i + 1) * w]).astype(np.int64)).to(cuda, torch.int32)
        for i in range(2)
    )
    coeffs = _field(BLS12_381_G1.scalar, n, 33)
    scal = nfr.from_mont(nfr.from_halflimbs(coeffs.astype(np.uint64)))
    pipe = CommitPipeline(BLS12_381_G1, cuda)
    c = torch.as_tensor(coeffs).to(cuda, torch.int32)

    def affine_u64(P):
        return np.concatenate([nc.fq.from_halflimbs(t.cpu().numpy().astype(np.uint64))
                               for t in pipe.ops.to_affine(P)], axis=1)

    got = affine_u64(pipe.commit_coefficient_basis(c, tuple(t[:n] for t in bases)))
    assert np.array_equal(got, nc.to_affine(nc.msm(aff[:n], scal)[None, :]))
    dens = DensityTracker()
    for i, bit in enumerate(rng.random(n) < 0.5):
        dens.add_element()
        if bit:
            dens.inc(i)
    idx = np.nonzero(dens.generate_mask(n))[0]
    got = affine_u64(pipe.commit_sparse(c, bases, dens, skip=skip))
    assert np.array_equal(got, nc.to_affine(nc.msm(aff[idx + skip], scal[idx])[None, :]))


# -- G2: K3's Fq2 instances ---------------------------------------------------

G2_CURVES = ["BLS12_381_G2", "BN254_G2"]


@pytest.mark.parametrize("curve", G2_CURVES)
def test_g2_point_kernel_matches_plain(cuda, curve):
    """The Fq2 point kernel == its plain version with every edge row of
    _point_rows, also with keep + out= (fused rows) and P affine; the
    launches count as Fq2 launches, not G1 ones."""
    from tpu_ec_torch import curves, kernels

    spec = getattr(curves, curve)
    ops = PointOps(spec, cuda)
    P, Q, A = _point_rows(ops)
    n, L = P[0].shape[0], ops.width
    keep = torch.zeros(n, dtype=torch.bool, device=cuda)
    keep[::3] = True
    kernels.reset_launch_counters()
    for op, ins in (("add", [*P, *Q]), ("add_mixed", [*P, *A]), ("double", [*P]), ("add_mixed", [*P[:2], *A])):
        got, want = point_op(spec.base, op, ins, ext=2), point_op_plain(spec.base, op, ins, ext=2)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), (op, len(ins))
        if op != "double":
            fused = torch.full((n, 3 * L), -1, dtype=torch.int32, device=cuda)
            got = point_op(spec.base, op, ins, keep=keep, out=fused, ext=2)
            want = point_op_plain(spec.base, op, ins, keep, ext=2)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (op, "keep")
            assert torch.equal(fused, torch.cat(want, dim=1))
    counts = kernels.launch_counters()
    assert (counts["point_fp2"], counts["point"]) == (7, 0)


@pytest.mark.parametrize("curve", G2_CURVES)
def test_g2_horner_kernel_matches_plain(cuda, curve):
    """The Fq2 Horner entry == its plain loop with every edge of
    _horner_edge_sums, C = 1 and 9, w = 0, 1 and 5."""
    from tpu_ec_torch import curves
    from tpu_ec_torch.kernels.point import horner, horner_plain

    spec = getattr(curves, curve)
    ops = PointOps(spec, cuda)
    kinds = ("same", "cancel", "garbage", "zero", "top", "random")
    for w in (0, 1, 5):
        for C in (1, 9):
            S = _horner_edge_sums(ops, C, w, kinds)
            got = horner(spec.base, S, w, ext=2)
            assert got[0].shape == (C, ops.width)
            assert all(torch.equal(g, h) for g, h in zip(got, horner_plain(spec.base, S, w, ext=2))), (w, C)


@pytest.mark.parametrize("curve", G2_CURVES)
def test_g2_scalar_mul_kernel_matches_plain(cuda, curve):
    """The Fq2 chain entry == the plain 256-step loop: per-row scalars (0,
    1, r - 1, 2^256 - 1, r + 2, ...) and one scalar for every row."""
    from tpu_ec_torch import curves
    from tpu_ec_torch.kernels.point import point_scalar_mul, scalar_mul_plain

    spec = getattr(curves, curve)
    ops = PointOps(spec, cuda)
    P, k = _chain_rows(ops, cuda)
    for kk in (k, k[6]):
        got = point_scalar_mul(spec.base, P, kk, ext=2)
        assert all(torch.equal(g, w) for g, w in zip(got, scalar_mul_plain(spec.base, P, kk, ext=2)))


@pytest.mark.parametrize("curve", G2_CURVES)
def test_g2_ec_fft_stage_kernel_matches_plain(cuda, curve):
    """The Fq2 EC-FFT stage entry == its plain version at every stage of two
    transforms of 64 points, with a == b, a == -b and identity rows."""
    from tpu_ec_torch import curves
    from tpu_ec_torch.kernels.point import ec_fft_stage, ec_fft_stage_plain
    from tpu_ec_torch.ops.ec_fft import get_ec_domain

    spec = getattr(curves, curve)
    ops = PointOps(spec, cuda)
    _, P = _points(ops, 128)
    Y = [c.reshape(2, 64, -1).clone() for c in P]
    negy = ops.F.neg(Y[1][1, 1:2])[0]
    for c in Y:
        c[0, 32] = c[0, 0]  # a == b
        c[1, 33] = c[1, 1]
        c[1, 2] = 0  # identity
    Y[1][1, 33] = negy  # a == -b
    tw = torch.as_tensor(get_ec_domain(spec, 6).twiddle_scalars.astype(np.int64)).to(cuda, torch.int32)
    for s in range(6):
        got, want = ec_fft_stage(spec.base, Y, tw, s, ext=2), ec_fft_stage_plain(spec.base, Y, tw, s, ext=2)
        assert all(torch.equal(g, w) for g, w in zip(got, want)), s
        Y = list(want)


def _g2_native_points(nc, n, seed):
    """n points k G2 with random 64-bit k (native), Jacobian and affine u64."""
    rng = np.random.default_rng(seed)
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    G = nc.affine_from_points([(nc.spec.gen_x, nc.spec.gen_y)])
    jac = nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks)
    return jac, nc.to_affine(jac)


def _to_port(nc, arr, k, cuda):
    w = nc.w
    return tuple(torch.as_tensor(nc.coord_to_halflimbs(arr[:, i * w : (i + 1) * w]).astype(np.int64))
                 .to(cuda, torch.int32) for i in range(k))


def _to_native(nc, coords):
    return np.concatenate([nc.coord_from_halflimbs(c.cpu().numpy()) for c in coords], axis=1)


@pytest.mark.parametrize("curve", G2_CURVES)
def test_g2_msm_and_batch_match_native(cuda, curve):
    """multiexp "auto" on G2 runs the scan engine (Fq2 K3 launches, no G1
    one) and == the native Pippenger at 2^10; multiple_multiexp, 4 chunks,
    each chunk == native."""
    from tpu_ec_torch import curves, kernels
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.msm import MultiexpKernel

    spec = getattr(curves, curve)
    nc = native_curve(spec)
    n = 1 << 10
    _, aff = _g2_native_points(nc, n, 32)
    bases = _to_port(nc, aff, 2, cuda)
    rng = np.random.default_rng(33)
    s = rng.integers(0, 1 << 16, (n, 16), dtype=np.int64)
    s[:, -1] &= 0x0FFF  # below r
    s[0] = 0
    kern = MultiexpKernel(spec, cuda)
    kernels.reset_launch_counters()
    got = kern.multiexp(bases, torch.as_tensor(s).to(cuda, torch.int32))
    counts = kernels.launch_counters()
    assert counts["point_fp2"] > 0 and counts["point_horner_fp2"] == 1 and counts["point"] == 0
    s64 = nc.fr.from_halflimbs(s.astype(np.uint64))
    assert np.array_equal(nc.to_affine(_to_native(nc, got)), nc.to_affine(nc.msm(aff, s64)[None, :]))
    C = 4
    out = kern.multiple_multiexp(bases, torch.as_tensor(s).to(cuda, torch.int32), C)
    m = n // C
    want = np.stack([nc.msm(aff[c * m : (c + 1) * m], s64[c * m : (c + 1) * m]) for c in range(C)])
    assert np.array_equal(nc.to_affine(_to_native(nc, out)), nc.to_affine(want))


def test_g2_ec_fft_matches_native(cuda):
    """A 2^6 BN254 G2 EC-FFT on the card == the native EC-FFT (affine), and
    its inverse gives the points back."""
    from tpu_ec_torch.curves import BN254_G2
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.ec_fft import EcFftKernel

    nc = native_curve(BN254_G2)
    jac, _ = _g2_native_points(nc, 1 << 6, 34)
    P = _to_port(nc, jac, 3, cuda)
    kern = EcFftKernel(BN254_G2, cuda)
    out = kern.radix_ec_fft(P)
    assert np.array_equal(nc.to_affine(_to_native(nc, out)), nc.to_affine(nc.ec_fft(jac)))
    back = kern.radix_ec_fft(out, inverse=True)
    ops = kern.ops
    assert all(torch.equal(a, b) for a, b in zip(ops.to_affine(back), ops.to_affine(P)))


# -- G2: the geometries of the Fq2 kernels (two lanes a row; a tile of 16 lanes a chain)


def _g2_edge_rows(ops, n):
    """_point_rows' P, Q, A (identity, P == Q, P == -Q, both identity, 0 and
    p - 1) at n rows (n >= 8), with rows 6 and 7 a garbage identity (z = 0,
    x and y those of a point) in P and in Q."""
    P, Q, A = _point_rows(ops, n)
    P[2][6] = 0
    Q[2][7] = 0
    return P, Q, A


@pytest.mark.parametrize("curve", G2_CURVES)
def test_g2_point_kernel_row_counts(cuda, curve):
    """The Fq2 point kernel == its plain version at row counts that are odd
    and not a multiple of a block's 64 rows (128 lanes, two a row): 1, 3,
    63, 65, 127, 129, every op, the edge rows among the first ones."""
    from tpu_ec_torch import curves

    spec = getattr(curves, curve)
    ops = PointOps(spec, cuda)
    P, Q, A = _g2_edge_rows(ops, 130)
    for n in (1, 3, 63, 65, 127, 129):
        p, q, a = ([c[:n] for c in X] for X in (P, Q, A))
        for op, ins in (("add", [*p, *q]), ("add_mixed", [*p, *a]), ("double", [*p]), ("add_mixed", [*p[:2], *a])):
            got, want = point_op(spec.base, op, ins, ext=2), point_op_plain(spec.base, op, ins, ext=2)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (n, op, len(ins))


@pytest.mark.parametrize("curve", G2_CURVES)
@pytest.mark.parametrize("offset", [0, 1])
def test_g2_point_kernel_scan_views(cuda, curve, offset):
    """The add as the scan engine calls it: P and Q column views of fused
    (n, 3 * 2L) row blocks (row stride 3 * 2L), keep, out= a fused block;
    offset 1 puts every row off its 16-byte alignment (the kernel's scalar
    loads and stores)."""
    from tpu_ec_torch import curves

    spec = getattr(curves, curve)
    ops = PointOps(spec, cuda)
    P, Q, _ = _g2_edge_rows(ops, 45)
    n, L = P[0].shape[0], ops.width
    keep = torch.zeros(n, dtype=torch.bool, device=cuda)
    keep[1::4] = True
    blocks = []
    for X in (P, Q):
        b = torch.zeros((n, 3 * L + offset), dtype=torch.int32, device=cuda)
        b[:, offset:] = torch.cat(X, dim=1)
        blocks.append(b[:, offset:])
    views = [b[:, k * L : (k + 1) * L] for b in blocks for k in range(3)]
    dst = torch.full((n, 3 * L + offset), -1, dtype=torch.int32, device=cuda)
    got = point_op(spec.base, "add", views, keep=keep, out=dst[:, offset:], ext=2)
    want = point_op_plain(spec.base, "add", [*P, *Q], keep, ext=2)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert torch.equal(dst[:, offset:], torch.cat(want, dim=1))


@pytest.mark.parametrize("curve", G2_CURVES)
def test_g2_chains_odd_tiles(cuda, curve):
    """The Fq2 chain entries at tile counts that leave a warp's second tile
    empty (16 lanes a chain, two chains a warp): the scalar multiplication at
    n = 1, 3 and 13 rows of _chain_rows (scalars 0, 1, 2, r - 1, r + 2: its
    last add meets acc == P; the identity and a garbage identity), per row
    and one scalar for all; the Horner at C = 1, 3 and 5 chunks; the stage
    entry on 3 transforms of 2 and of 4 points (3 and 6 butterflies), every
    stage.  Each == its plain version."""
    from tpu_ec_torch import curves
    from tpu_ec_torch.kernels.point import (chain_tile, ec_fft_stage, ec_fft_stage_plain, horner, horner_plain,
                                            point_scalar_mul, scalar_mul_plain)
    from tpu_ec_torch.ops.ec_fft import get_ec_domain

    spec = getattr(curves, curve)
    assert chain_tile(spec.base, 2) == 16
    ops = PointOps(spec, cuda)
    P, k = _chain_rows(ops, cuda, n=16)
    for n in (1, 3, 13):
        p = [c[:n] for c in P]
        for kk in (k[:n], k[3]):
            got = point_scalar_mul(spec.base, p, kk, ext=2)
            assert all(torch.equal(g, w) for g, w in zip(got, scalar_mul_plain(spec.base, p, kk, ext=2))), n
    kinds = ("same", "cancel", "garbage", "zero", "top", "random")
    for C in (1, 3, 5):
        S = _horner_edge_sums(ops, C, 3, kinds)
        assert all(torch.equal(g, h) for g, h in zip(horner(spec.base, S, 3, ext=2),
                                                     horner_plain(spec.base, S, 3, ext=2))), C
    _, Pt = _points(ops, 12)
    for lg in (1, 2):
        Y = [c[: 3 << lg].reshape(3, 1 << lg, -1).clone() for c in Pt]
        tw = torch.as_tensor(get_ec_domain(spec, lg).twiddle_scalars.astype(np.int64)).to(cuda, torch.int32)
        for s in range(lg):
            got, want = ec_fft_stage(spec.base, Y, tw, s, ext=2), ec_fft_stage_plain(spec.base, Y, tw, s, ext=2)
            assert all(torch.equal(g, w) for g, w in zip(got, want)), (lg, s)
            Y = list(want)


@pytest.mark.parametrize("n", [1, 255, 256, 257, 4096 + 16, 3 * 256 + 77])
def test_inter_int8_kernel_tiles(cuda, n):
    """K2's int8 entry (a tile of 256 columns a block, staged in shared
    memory) at n = 1, a tile edge, a tile and one, whole tiles plus a
    16-column tail, and an odd ragged n: canonical planes and rows and int8
    digits out, one constant twiddle and twiddle rows (t_rep 1, and 2 where
    n is even); the int32 entry beside it.  Each == its plain version."""
    spec = tfp.BLS12_381_FR
    rng = np.random.default_rng(20 + n)
    dig = torch.as_tensor(rng.integers(0, 128, (37, n))).to(cuda, torch.int8)
    dig[:, 0] = 127
    t = torch.as_tensor(_field(spec, max(n, 8), 21)).to(cuda, torch.int32)
    cases = [(t[3], dict(const_t=True))] + [(t[: n // r].contiguous(), dict(t_rep=r)) for r in (1, 2) if n % r == 0]
    for t16, kw in cases:
        for canonical, rows in ((True, False), (True, True), (False, False)):
            want = inter_twiddle_plain(spec, dig, t16, canonical=canonical, **kw)
            got = inter_twiddle(spec, dig, t16, canonical=canonical, out_rows=rows, **kw)
            assert torch.equal(got, want.T if rows else want), (kw, canonical, rows)
    cols = torch.as_tensor(rng.integers(0, (1 << 7) * 37 * 127 * 127, (40, n))).to(cuda, torch.int32)
    for canonical in (False, True):
        want = inter_twiddle_plain(spec, cols, t[:n].contiguous(), canonical=canonical)
        assert torch.equal(inter_twiddle(spec, cols, t[:n].contiguous(), canonical=canonical), want)


@pytest.mark.parametrize("curve", ["BLS12_381_G1", "BN254_G1", "BLS12_381_G2"])
def test_lattice_msm_matches_native(cuda, curve):
    """The bucket lattice on the card at n = 2^10 (G1) or 2^8 (G2):
    ``multiexp(signed=False)`` ("auto" = the lattice; identity base and zero
    scalar rows included), ``method="lattice"`` signed and ``multiexp_1bit``,
    each == the native Pippenger, with K3's launches (G1 or Fq2, one
    Horner) as ``lattice_steps`` counts them."""
    from tpu_ec_torch import curves, kernels
    from tpu_ec_torch.native import native_curve
    from tpu_ec_torch.ops.msm import (MultiexpKernel, default_num_groups, default_window_size, lattice_steps,
                                      multiexp_1bit)

    spec = getattr(curves, curve)
    nc = native_curve(spec)
    n = 1 << (8 if spec.ext == 2 else 10)
    _, aff = _g2_native_points(nc, n, 40)
    aff[5] = 0  # an identity base
    bases = _to_port(nc, aff, 2, cuda)
    rng = np.random.default_rng(41)
    s = rng.integers(0, 1 << 16, (n, 16), dtype=np.int64)
    s[:, -1] &= 0x0FFF  # below r
    s[0] = 0
    scal = torch.as_tensor(s).to(cuda, torch.int32)
    want = nc.to_affine(nc.msm(aff, nc.fr.from_halflimbs(s.astype(np.uint64)))[None, :])
    kern = MultiexpKernel(spec, cuda)
    names = ("point", "point_horner") if spec.ext == 1 else ("point_fp2", "point_horner_fp2")
    for run, w, signed in ((lambda: kern.multiexp(bases, scal, signed=False), None, False),
                           (lambda: kern.multiexp(bases, scal, method="lattice"), None, True),
                           (lambda: multiexp_1bit(spec, bases, scal, device=cuda), 1, False)):
        kernels.reset_launch_counters()
        got = run()
        counts = kernels.launch_counters()
        w = w or default_window_size(n)
        G = default_num_groups(n, w)
        assert (counts[names[0]], counts[names[1]]) == (sum(lattice_steps(-(-n // G), G, w, signed).values()), 1)
        assert np.array_equal(nc.to_affine(_to_native(nc, got)), want), (w, signed)
