"""The port's paths on the card at the sizes where the size is the point, and
the kernels each path must launch.

The digit NTT from 2^22 to 2^26 on the default thresholds and on its chunked
route, the planes batch, K2's int8 entry at the 2^26 final pass, a G2
commit, a G2 MSM at 2^20 on the pair and the scan engine, the multi-device
layer in an NCCL group of one card, and the sorted engine at 2^20.
Referees: the native C++ library (``tpu_ec_torch.native``) and the
single-card paths.  Launch counts come from the engines' own plans
(``sorted_steps``, ``pair_steps``, the fused domain's plan), or a call must
launch what the call before it did.

Every test needs a CUDA device and skips without one.  The file imports no
JAX, so it also runs where jax is not installed:

    python -m pytest --noconftest -q tests/test_torch_cuda_scale.py

(``--noconftest``: tests/conftest.py sets up JAX.)  Tolerance: none
(integers).
"""

from concurrent.futures import ThreadPoolExecutor

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import torch.distributed as dist
from test_torch_cuda import _field, _g2_native_points as _native_points, _to_native, _to_port
from tpu_ec_torch import kernels
from tpu_ec_torch.curves import BLS12_381_G1, BLS12_381_G2, BN254_G1, BN254_G2, PointOps
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.native import native_curve, native_field
from tpu_ec_torch.ops import ntt_digit
from tpu_ec_torch.ops.ntt import FftKernel

pytestmark = pytest.mark.cuda

SEED = 20240601
NTT_LAUNCHES = ("mont_mul", "inter_twiddle", "inter_twiddle_i8")


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.fixture
def cuda():
    return _card()


def _gen(dev, seed):
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED + seed)
    return gen


def _rand_fr(spec, shape, gen, dev):
    """Random elements below p's top limb, (*shape, L) int32 half-limbs on dev."""
    x = torch.randint(0, 1 << 16, (*shape, spec.n_limbs), generator=gen, device=dev, dtype=torch.int32)
    x[..., -1] = torch.randint(0, int(spec.p_limbs[-1]), shape, generator=gen, device=dev, dtype=torch.int32)
    return x


def _words(x, block=1 << 22):
    """(n, 16) half-limbs on the card -> the native (n, 4) u64 words."""
    shifts = torch.tensor([0, 16, 32, 48], dtype=torch.int64, device=x.device)
    return np.concatenate([(x[s : s + block].to(torch.int64).view(-1, 4, 4) << shifts).sum(-1).cpu().numpy()
                           for s in range(0, x.shape[0], block)]).view(np.uint64)


def _launched(names=NTT_LAUNCHES):
    counts = kernels.launch_counters()
    return {k: counts[k] for k in names}


# -- the digit NTT at 2^22 .. 2^26 ---------------------------------------------


@pytest.mark.parametrize("field,log_n,chunk_min", [("BLS12_381_FR", 22, None), ("BLS12_381_FR", 24, None),
                                                   ("BLS12_381_FR", 26, None), ("BN254_FR", 22, 1 << 22)],
                         ids=["bls12_381_2p22", "bls12_381_2p24", "bls12_381_2p26", "bn254_2p22_chunked"])
def test_digit_ntt_matches_native(cuda, monkeypatch, field, log_n, chunk_min):
    """``FftKernel.radix_fft`` on the default thresholds (level tables built
    on the card by K1, unchunked) and BN254 Fr on the chunked route
    (factored seeds, K2's int8 entry): every row == the native NTT, the
    inverse gives the input back, and a call launches what the call before
    it did, K2's int8 entry exactly where the domain runs chunked."""
    spec = getattr(tfp, field)
    if chunk_min:
        monkeypatch.setattr(ntt_digit, "_CHUNK_MIN", chunk_min)
    x = _rand_fr(spec, (1 << log_n,), _gen(cuda, log_n), cuda)
    with ThreadPoolExecutor(1) as referee:  # the native NTT runs beside the card
        want = referee.submit(native_field(spec).ntt, _words(x))
        k = FftKernel(spec, cuda)
        kernels.reset_launch_counters()
        y = k.radix_fft(x)
        first = _launched()
        assert first["mont_mul"] and first["inter_twiddle"], first  # K1 builds the tables
        calls = []
        for _ in range(2):
            kernels.reset_launch_counters()
            assert torch.equal(k.radix_fft(x), y)
            calls.append(_launched())
        dom = ntt_digit.get_digit_domain(spec, log_n, False, ntt_digit.leaf_log(log_n))
        chunked = (1 << log_n) >= dom.chunk_min
        assert chunked == bool(chunk_min)
        assert calls[0] == calls[1] and calls[0]["inter_twiddle"], calls
        assert bool(calls[0]["inter_twiddle_i8"]) == chunked, calls
        assert torch.equal(k.radix_fft(y, inverse=True), x)
        assert np.array_equal(_words(y), want.result())


def test_digit_ntt_2p26_chunk_routes_agree(cuda, monkeypatch):
    """At 2^26 the route the thresholds pick (unchunked) and the chunked one
    (16 slices a level, factored seeds, K2's int8 entry) give the same
    transform bit for bit."""
    spec = tfp.BLS12_381_FR
    x = _rand_fr(spec, (1 << 26,), _gen(cuda, 1), cuda)
    want = FftKernel(spec, cuda).radix_fft(x)
    torch.cuda.empty_cache()
    monkeypatch.setattr(ntt_digit, "_CHUNK_MIN", 1 << 26)
    kernels.reset_launch_counters()
    got = FftKernel(spec, cuda).radix_fft(x)
    assert _launched()["inter_twiddle_i8"]
    assert "factored" in ntt_digit.get_digit_domain(spec, 26, False, ntt_digit.leaf_log(26)).inter.values()
    assert torch.equal(got, want)


def test_digit_ntt_planes_batch_matches_native(cuda):
    """``digit_ntt_planes_batch`` at (2^13, 2^11), the local stage of a 2^26
    four-step split on one of four shards: 16 sampled columns == the native
    NTT, and the inverse batch gives the input back."""
    spec, n, B = tfp.BLS12_381_FR, 1 << 13, 1 << 11
    gen = _gen(cuda, 2)
    xb = _rand_fr(spec, (n, B), gen, cuda).permute(2, 0, 1).contiguous()  # (16, n, B) planes
    kernels.reset_launch_counters()
    yb = ntt_digit.digit_ntt_planes_batch(spec, xb)
    assert _launched()["inter_twiddle"]
    nf = native_field(spec)
    for b in torch.randperm(B, generator=gen, device=cuda)[:16].tolist():
        want = nf.ntt(_words(xb[:, :, b].T.contiguous()))
        assert np.array_equal(_words(yb[:, :, b].T.contiguous()), want), b
    assert torch.equal(ntt_digit.digit_ntt_planes_batch(spec, yb, True), xb)


def test_inter_int8_entry_at_2p26_matches_plain(cuda):
    """K2's int8 entry at the 2^26 final pass's shape, (37, 2^26) int8 digits
    times the constant twiddle into (2^26, 16) canonical rows (its
    persistent grid walking many tiles a block), == its plain version."""
    from tpu_ec_torch.kernels.inter import inter_twiddle, inter_twiddle_plain

    spec, n, step = tfp.BLS12_381_FR, 1 << 26, 1 << 19
    dom = ntt_digit.get_digit_domain(spec, 26, False, ntt_digit.leaf_log(26))
    c = torch.as_tensor(dom.final_c.astype(np.int64)).to(cuda, torch.int32)
    dig = torch.randint(0, 128, (37, n), generator=_gen(cuda, 3), device=cuda, dtype=torch.int8)
    kw = dict(canonical=True, const_t=True)
    got = inter_twiddle(spec, dig, c, out_rows=True, **kw)
    for s in range(0, n, step):
        assert torch.equal(got[s : s + step], inter_twiddle_plain(spec, dig[:, s : s + step], c, **kw).T), s


def test_fused_ntt_launches_its_plan(cuda, monkeypatch):
    """The fused NTT (config ``ntt_impl`` "fused") at 2^17, plan [8, 8, 1]:
    K4 with the level epilogue once a level, the plain leaf once, no K1;
    == the digit route."""
    from tpu_ec_torch.config import get_config
    from tpu_ec_torch.ops.ntt_fused import get_fused_domain

    spec = tfp.BLS12_381_FR
    x = _rand_fr(spec, (1 << 17,), _gen(cuda, 4), cuda)
    want = FftKernel(spec, cuda).radix_fft(x)
    monkeypatch.setattr(get_config(), "ntt_impl", "fused")
    k = FftKernel(spec, cuda)
    k.radix_fft(x)  # the tables
    kernels.reset_launch_counters()
    got = k.radix_fft(x)
    levels = len(get_fused_domain(spec, 17).plan) - 1
    assert levels == 2
    assert _launched(("ntt_leaf_level", "ntt_leaf", "mont_mul")) == {"ntt_leaf_level": levels, "ntt_leaf": 1,
                                                                   "mont_mul": 0}
    assert torch.equal(got, want)


# -- G2 and the paths off the cells ----------------------------------------------


def test_g2_commit_2p16_matches_native(cuda):
    """``CommitPipeline(BLS12-381 G2).commit`` at 2^16 (the digit NTT,
    from_mont, the pair MSM on K3's Fq2 kernels and no G1 one): the
    evaluations == the native NTT, the commitment == the native Pippenger."""
    from tpu_ec_torch.ops.pipeline import CommitPipeline

    n = 1 << 16
    nc, nfr = native_curve(BLS12_381_G2), native_field(BLS12_381_G2.scalar)
    _, aff = _native_points(nc, n, 60)
    coeffs = _field(BLS12_381_G2.scalar, n, 61)
    pipe = CommitPipeline(BLS12_381_G2, cuda)
    kernels.reset_launch_counters()
    evals, com = pipe.commit(torch.as_tensor(coeffs).to(cuda, torch.int32), _to_port(nc, aff, 2, cuda))
    counts = _launched(("mont_mul", "inter_twiddle", "point_fp2", "point_horner_fp2", "point"))
    assert all(counts[k] for k in ("mont_mul", "inter_twiddle", "point_fp2", "point_horner_fp2")), counts
    assert counts["point"] == 0, counts
    want_e = nfr.ntt(nfr.from_halflimbs(coeffs.astype(np.uint64)))
    assert np.array_equal(nfr.from_halflimbs(evals.cpu().numpy().astype(np.uint64)), want_e)
    want = nc.to_affine(nc.msm(aff, nfr.from_mont(want_e))[None, :])
    assert np.array_equal(nc.to_affine(_to_native(nc, com)), want)


def test_g2_msm_2p20_pair_equals_scan(cuda):
    """A BLS12-381 G2 MSM at 2^20 on the pair engine ("auto") and on the
    scan engine give the same affine point; the pair run launches K3's Fq2
    instances as ``pair_steps`` counts them, and no G1 one."""
    from tpu_ec_torch.ops.autotune import tuned_window
    from tpu_ec_torch.ops.msm import MultiexpKernel
    from tpu_ec_torch.ops.msm_pair import default_window_size_pair, pair_steps

    n = 1 << 20
    nc = native_curve(BLS12_381_G2)
    bases = tuple(c.repeat(16, 1) for c in _to_port(nc, _native_points(nc, 1 << 16, 64)[1], 2, cuda))
    scal = torch.as_tensor(_field(BLS12_381_G2.scalar, n, 65)).to(cuda, torch.int32)
    kern = MultiexpKernel(BLS12_381_G2, cuda, chunk_size=n)
    w = tuned_window(BLS12_381_G2.name, "pair", n) or default_window_size_pair(n)
    kernels.reset_launch_counters()
    pair = kern.ops.to_affine(kern.multiexp(bases, scal))
    assert _launched(("point_fp2", "point_horner_fp2", "point")) == {
        "point_fp2": sum(pair_steps(n, w).values()), "point_horner_fp2": 1, "point": 0}
    torch.cuda.empty_cache()
    scan = kern.ops.to_affine(kern.multiexp(bases, scal, method="scan"))
    assert all(torch.equal(a, b) for a, b in zip(pair, scan))


def test_g2_chain_paths_launch_fq2_entries(cuda):
    """G2's scalar multiplication and a 2^6 BN254 G2 EC-FFT run K3's Fq2
    chain entries: one stage launch a stage, and one chain launch for the
    inverse's scaling (the values: tests/test_torch_cuda.py)."""
    from tpu_ec_torch.ops.ec_fft import EcFftKernel

    nc = native_curve(BN254_G2)
    jac, _ = _native_points(nc, 1 << 6, 62)
    P = _to_port(nc, jac, 3, cuda)
    kern = EcFftKernel(BN254_G2, cuda)
    names = ("ec_fft_stage_fp2", "point_scalar_mul_fp2", "ec_fft_stage", "point_scalar_mul")
    kernels.reset_launch_counters()
    out = kern.radix_ec_fft(P)
    assert _launched(names) == {"ec_fft_stage_fp2": 6, "point_scalar_mul_fp2": 0, "ec_fft_stage": 0,
                                "point_scalar_mul": 0}
    kernels.reset_launch_counters()
    kern.radix_ec_fft(out, inverse=True)
    assert _launched(names) == {"ec_fft_stage_fp2": 6, "point_scalar_mul_fp2": 1, "ec_fft_stage": 0,
                                "point_scalar_mul": 0}
    k = torch.as_tensor(_field(BN254_G2.scalar, 1 << 6, 63)).to(cuda, torch.int32)
    kernels.reset_launch_counters()
    PointOps(BN254_G2, cuda).scalar_mul(P, k)
    assert _launched(names)["point_scalar_mul_fp2"] == 1


def test_g1_side_paths_launch_their_kernels(cuda):
    """The co-Z MSM launches K6 and K7's denominators, ``affine_add_batch``
    K7 (and == the Jacobian mixed add, with identity, P == Q and P == -Q
    rows), the coefficient-basis and sparse commits K1 and K3 (their
    values: tests/test_torch_cuda.py)."""
    from tpu_ec_torch.ops.affine import affine_add_batch
    from tpu_ec_torch.ops.density import DensityTracker
    from tpu_ec_torch.ops.msm import MultiexpKernel
    from tpu_ec_torch.ops.pipeline import CommitPipeline

    n = 1 << 12
    nc = native_curve(BLS12_381_G1)
    _, aff = _native_points(nc, 2 * n, 64)
    bases = _to_port(nc, aff[:n], 2, cuda)
    scal = torch.as_tensor(_field(BLS12_381_G1.scalar, n, 65)).to(cuda, torch.int32)
    kernels.reset_launch_counters()
    MultiexpKernel(BLS12_381_G1, cuda).multiexp(bases, scal, method="coz")
    counts = _launched(("coz_apply", "affine_denom"))
    assert all(counts.values()), counts

    ops = PointOps(BLS12_381_G1, cuda)
    A = tuple(c.clone() for c in bases)
    B = tuple(c.clone() for c in _to_port(nc, aff[n:], 2, cuda))
    for c in A:
        c[0] = 0  # A = identity
    for c, d in zip(B, A):
        c[1] = d[1]  # B == A
    B[0][2], B[1][2] = A[0][2], ops.F.neg(A[1][2:3])[0]  # B == -A
    kernels.reset_launch_counters()
    got = affine_add_batch(BLS12_381_G1.base, A, B)
    counts = _launched(("affine_denom", "affine_apply"))
    assert all(counts.values()), counts
    want = ops.to_affine(ops.add_mixed(ops.to_jacobian(A), B))
    assert all(torch.equal(g, w) for g, w in zip(got, want))

    pipe = CommitPipeline(BLS12_381_G1, cuda)
    dens = DensityTracker()
    for i, bit in enumerate(np.random.default_rng(66).random(n) < 0.5):
        dens.add_element()
        if bit:
            dens.inc(i)
    coeffs = torch.as_tensor(_field(BLS12_381_G1.scalar, n, 67)).to(cuda, torch.int32)
    for run in (lambda: pipe.commit_coefficient_basis(coeffs, bases), lambda: pipe.commit_sparse(coeffs, bases, dens)):
        kernels.reset_launch_counters()
        run()
        counts = _launched(("mont_mul", "point"))
        assert all(counts.values()), counts


# -- the multi-device layer on one card, and the sorted engine ------------------


def test_process_groups_put_the_mesh_on_the_card(cuda, tmp_path):
    """A group started with no backend named ("cpu:gloo,cuda:nccl" on a
    card) puts the mesh on the card (its probe: a K1 launch and an
    all_gather through NCCL), and ``dryrun_multichip(1)`` passes in a
    spawned NCCL rank (the 2^14 NTT == ``ntt_ref``, the 2^10 MSM == the
    native Pippenger)."""
    from tpu_ec_torch.entry import dryrun_multichip
    from tpu_ec_torch.parallel import make_mesh

    torch.cuda.set_device(0)
    dist.init_process_group(store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        backends, mesh = dist.get_backend_config(), make_mesh(probe=True)
    finally:
        dist.destroy_process_group()
    assert mesh is not None and mesh.device.type == "cuda", (backends, mesh)
    dryrun_multichip(1)


@pytest.fixture(scope="module")
def nccl_mesh(tmp_path_factory):
    """A mesh over an NCCL process group of world size 1 on cuda:0, started
    from a FileStore (NCCL takes one rank a card, so the exchanges are
    degenerate here; d >= 2 runs on gloo in the CPU tests)."""
    from tpu_ec_torch.parallel import make_mesh

    _card()
    torch.cuda.set_device(0)
    store = dist.FileStore(str(tmp_path_factory.mktemp("nccl") / "store"), 1)
    dist.init_process_group("nccl", store=store, rank=0, world_size=1)
    try:
        mesh = make_mesh()
        assert mesh.device.type == "cuda" and mesh.size == 1, mesh
        yield mesh
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def g1_2p20():
    """2^20 BLS12-381 G1 bases (2^16 native points k G, tiled 16 times),
    plain Fr scalars, and their MSM from the native Pippenger (affine)."""
    dev = _card()
    nc = native_curve(BLS12_381_G1)
    aff = np.tile(_native_points(nc, 1 << 16, 70)[1], (16, 1))
    s = _field(BLS12_381_G1.scalar, 1 << 20, 71)
    want = nc.to_affine(nc.msm(aff, nc.fr.from_halflimbs(s.astype(np.uint64)))[None, :])
    return _to_port(nc, aff, 2, dev), torch.as_tensor(s).to(dev, torch.int32), want


def test_dist_ntt_2p26_matches_single_card(cuda, nccl_mesh):
    """``DistFftKernel`` at 2^26 (n1 = n2 = 2^13, the digit route's local
    stages) == the single-card transform on every row, its inverse gives
    the input back, and a call launches what the call before it did."""
    from tpu_ec_torch.parallel import DistFftKernel, shard_leading

    spec, log_n = tfp.BLS12_381_FR, 26
    x = _rand_fr(spec, (1 << log_n,), _gen(cuda, 6), cuda)
    want = FftKernel(spec, cuda).radix_fft(x)
    torch.cuda.empty_cache()
    kern = DistFftKernel(spec, nccl_mesh)
    kernels.reset_launch_counters()
    y = kern.radix_fft(shard_leading(x, nccl_mesh))
    first = _launched()
    assert first["mont_mul"] and first["inter_twiddle"], first
    assert kern.plan(log_n, False).digit
    assert torch.equal(y, want)
    del want
    calls = []
    for _ in range(2):
        kernels.reset_launch_counters()
        assert torch.equal(kern.radix_fft(shard_leading(x, nccl_mesh)), y)
        calls.append(_launched())
    assert calls[0] == calls[1] and calls[0]["inter_twiddle"], calls
    assert torch.equal(kern.radix_fft(y, inverse=True), x)


@pytest.mark.parametrize("accum", ["pair", "scan"])
def test_dist_msm_2p20_matches_native(cuda, nccl_mesh, g1_2p20, monkeypatch, accum):
    """``DistMultiexpKernel`` at 2^20 with each bucket accumulation (config
    ``dist_msm_accum``) == the native Pippenger."""
    from tpu_ec_torch.config import get_config
    from tpu_ec_torch.parallel import DistMultiexpKernel, shard_leading

    bases, scal, want = g1_2p20
    monkeypatch.setattr(get_config(), "dist_msm_accum", accum)
    kernels.reset_launch_counters()
    out = DistMultiexpKernel(BLS12_381_G1, nccl_mesh).multiexp(shard_leading(bases, nccl_mesh),
                                                              shard_leading(scal, nccl_mesh))
    counts = _launched(("point", "point_horner", "point_scalar_mul"))
    assert all(counts.values()), counts
    nc = native_curve(BLS12_381_G1)
    assert np.array_equal(nc.to_affine(_to_native(nc, out)), want)


def test_dist_ec_fft_matches_single_card(cuda, nccl_mesh):
    """``DistEcFftKernel`` on a BN254 G1 batch of 16 x 2^11 == the single-card
    ``radix_ec_fft_many``."""
    from tpu_ec_torch.ops.ec_fft import EcFftKernel
    from tpu_ec_torch.parallel import DistEcFftKernel, shard_leading

    nc = native_curve(BN254_G1)
    P = tuple(c.view(16, 1 << 11, -1) for c in _to_port(nc, _native_points(nc, 16 << 11, 80)[0], 3, cuda))
    want = EcFftKernel(BN254_G1, cuda).radix_ec_fft_many(P)
    kernels.reset_launch_counters()
    got = DistEcFftKernel(BN254_G1, nccl_mesh).radix_ec_fft_many(shard_leading(P, nccl_mesh))
    assert _launched(("ec_fft_stage",))["ec_fft_stage"]
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_sorted_msm_2p20_matches_native(cuda, g1_2p20):
    """``multiexp(method="sorted")`` at 2^20 in one engine call: its K3
    launches as ``sorted_steps`` counts them (the Horner's among them), and
    == the native Pippenger."""
    from tpu_ec_torch.ops.msm import MultiexpKernel
    from tpu_ec_torch.ops.msm_sorted import default_window_size_sorted, sorted_steps

    bases, scal, want = g1_2p20
    n = scal.shape[0]
    w = default_window_size_sorted(n)
    kernels.reset_launch_counters()
    out = MultiexpKernel(BLS12_381_G1, cuda, chunk_size=n).multiexp(bases, scal, window_size=w, method="sorted")
    assert _launched(("point", "point_horner")) == {"point": sum(sorted_steps(n, w).values()), "point_horner": 1}
    nc = native_curve(BLS12_381_G1)
    assert np.array_equal(nc.to_affine(_to_native(nc, out)), want)
