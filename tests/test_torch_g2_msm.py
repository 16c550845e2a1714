"""The port's G2 MSM: ``multiexp`` and ``multiple_multiexp`` with method
"auto", which runs the pair engine on G2 (tpu_ec's runs the scan engine
there), and with method "scan", against the bigint oracle
(tpu_ec/curves/oracle.py) and the native C++ Pippenger with ext = 2.  Not
against tpu_ec's own G2 scan program: its XLA-CPU compile takes minutes
(tests/test_msm_scan.py marks it slow).

Inputs from oracle seeds, with identity bases and zero scalars; small
windows keep the plain K3 loops short.  Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G2 as J_BLS, BN254_G2 as J_BN
from tpu_ec_torch import kernels
from tpu_ec_torch.curves import BLS12_381_G2, BN254_G2
from tpu_ec_torch.native import native_curve
from tpu_ec_torch.ops.msm import MultiexpKernel


def _inputs(jspec, n, seed):
    pts = oracle.random_points(jspec, n, seed=seed)
    ks = oracle.random_scalars(jspec, n, seed=seed + 1)
    pts[1] = None  # identity base
    ks[2] = 0  # zero scalar
    ks[3] = jspec.scalar.modulus - 1
    return pts, ks


@pytest.mark.parametrize("curve,n,w", [("BN254", 9, 2), ("BLS12_381", 9, 3), ("BN254", 33, 4)])
@pytest.mark.parametrize("method", ["auto", "scan"])
def test_multiexp_auto_is_scan_and_matches_oracle_and_native(curve, n, w, method):
    """"auto" (the pair engine) and the scan engine give the same affine
    point as the native Pippenger and the oracle."""
    jspec, tspec = {"BN254": (J_BN, BN254_G2), "BLS12_381": (J_BLS, BLS12_381_G2)}[curve]
    pts, ks = _inputs(jspec, n, seed=80 + n)
    kern = MultiexpKernel(tspec, "cpu")
    ops = kern.ops
    got = kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), window_size=w, method=method)
    assert got[0].shape == (1, 2 * ops.L)
    want = ops.to_affine_ints(ops.to_affine(got))[0]
    assert want == native_curve(tspec).msm_points(pts, ks)
    if n < 10:  # the oracle's bigint double-and-add is slow at the larger size
        assert want == oracle.msm(jspec, pts, ks)


def test_auto_runs_the_scan_engine(monkeypatch):
    """"auto" on G2 calls the pair engine (no longer tpu_ec's scan engine),
    for one MSM and for a batch."""
    from tpu_ec_torch.ops import msm_pair, msm_scan

    calls = []
    real = msm_pair.msm_pair

    def spy(*a, **k):
        calls.append(a[2].dim())
        return real(*a, **k)

    def scan_spy(*a, **k):
        raise AssertionError("auto ran the scan engine")

    monkeypatch.setattr(msm_pair, "msm_pair", spy)
    monkeypatch.setattr(msm_scan, "msm_scan", scan_spy)
    kern = MultiexpKernel(BN254_G2, "cpu")
    ops = kern.ops
    pts, ks = _inputs(J_BN, 4, seed=90)
    bases, scal = ops.from_affine_ints(pts), ops.scalars_to_limbs(ks)
    kern.multiexp(bases, scal, window_size=2)
    kern.multiple_multiexp(bases, scal, 2, window_size=2)
    assert calls == [2, 3]


def test_multiple_multiexp_three_chunks():
    pts, ks = _inputs(J_BN, 12, seed=91)
    pts[5] = None
    ks[9] = 0
    kern = MultiexpKernel(BN254_G2, "cpu")
    ops = kern.ops
    out = kern.multiple_multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), 3, window_size=3)
    assert out[0].shape == (3, 2 * ops.L)
    got = ops.to_affine_ints(ops.to_affine(out))
    assert got == [oracle.msm(J_BN, pts[c * 4 : (c + 1) * 4], ks[c * 4 : (c + 1) * 4]) for c in range(3)]


@pytest.mark.parametrize("curve", ["BN254", "BLS12_381"])
def test_pair_one_bucket_matches_native(curve, monkeypatch):
    """Every scalar equal: each window's rows form one run of the whole
    length, so every pair round merges, every spill generation holds that
    key's boundary rows and the finish folds them; == the native
    Pippenger, in the K3 ops ``pair_steps`` counts (one launch each on the
    card)."""
    from tpu_ec_torch.curves import point as point_mod
    from tpu_ec_torch.ops import msm_pair

    jspec, tspec = {"BN254": (J_BN, BN254_G2), "BLS12_381": (J_BLS, BLS12_381_G2)}[curve]
    n, w = 11, 3  # padded to 16 rows: four rounds, the padding rows a second key
    pts = oracle.random_points(jspec, n, seed=96)
    pts[4] = None
    ks = [oracle.random_scalars(jspec, 1, seed=97)[0]] * n
    calls = []

    def count(mod, name):
        real = getattr(mod, name)

        def counted(*a, **k):
            calls.append(name)
            return real(*a, **k)

        monkeypatch.setattr(mod, name, counted)

    count(point_mod, "point_op")
    count(msm_pair, "horner")
    kern = MultiexpKernel(tspec, "cpu")
    ops = kern.ops
    got = kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), window_size=w, method="pair")
    assert calls == ["point_op"] * (sum(msm_pair.pair_steps(n, w).values()) - 1) + ["horner"]
    assert ops.to_affine_ints(ops.to_affine(got))[0] == native_curve(tspec).msm_points(pts, ks)


def test_multiple_multiexp_bls12_381_matches_oracle():
    """BLS12-381 G2 ``multiple_multiexp`` on "auto" (the pair engine with a
    chunk axis): two chunks, one with a zero scalar and an identity base,
    each == the oracle."""
    pts, ks = _inputs(J_BLS, 8, seed=98)
    kern = MultiexpKernel(BLS12_381_G2, "cpu")
    ops = kern.ops
    out = kern.multiple_multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), 2, window_size=3)
    assert out[0].shape == (2, 2 * ops.L)
    got = ops.to_affine_ints(ops.to_affine(out))
    assert got == [oracle.msm(J_BLS, pts[c * 4 : (c + 1) * 4], ks[c * 4 : (c + 1) * 4]) for c in range(2)]


@pytest.mark.parametrize("method", ["coz"])
def test_g1_only_engines_raise_for_g2(method):
    kern = MultiexpKernel(BN254_G2, "cpu")
    ops = kern.ops
    pts, ks = _inputs(J_BN, 4, seed=92)
    with pytest.raises(NotImplementedError, match="G1-only"):
        kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), window_size=2, method=method)


def test_g2_launches_count_apart_on_the_card_only():
    """On the CPU the plain versions run: no launch counts, G1's or G2's."""
    kernels.reset_launch_counters()
    kern = MultiexpKernel(BN254_G2, "cpu")
    ops = kern.ops
    pts, ks = _inputs(J_BN, 4, seed=93)
    kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), window_size=2)
    assert not any(kernels.launch_counters().values())


def test_g2_commits_and_density():
    """CommitPipeline on G2: the coefficient-basis commit and the sparse
    commit (compact_by_density on (n, 2L) bases, skip 1) equal the native
    Pippenger over the same terms; commit's MSM takes the NTT's values."""
    from tpu_ec_torch.fields import FieldOps
    from tpu_ec_torch.ops.density import DensityTracker
    from tpu_ec_torch.ops.pipeline import CommitPipeline

    pts = oracle.random_points(J_BN, 5, seed=94)
    pipe = CommitPipeline(BN254_G2, "cpu")
    ops, fr = pipe.ops, FieldOps(BN254_G2.scalar, "cpu")
    ks = oracle.random_scalars(J_BN, 4, seed=95)
    coeffs = fr.from_ints(ks)
    bases = ops.from_affine_ints(pts)
    nc = native_curve(BN254_G2)
    aff = lambda P: ops.to_affine_ints(ops.to_affine(P))[0]
    assert aff(pipe.commit_coefficient_basis(coeffs, tuple(c[:4] for c in bases))) == nc.msm_points(pts[:4], ks)
    dens = DensityTracker()
    for i in range(4):
        dens.add_element()
        if i != 2:
            dens.inc(i)
    got = aff(pipe.commit_sparse(coeffs, bases, dens, skip=1))
    assert got == nc.msm_points([pts[1], pts[2], pts[4]], [ks[0], ks[1], ks[3]])
    evals, com = pipe.commit(coeffs, tuple(c[:4] for c in bases))
    assert aff(com) == nc.msm_points(pts[:4], fr.to_ints(evals))


def test_g2_entry_points_default_to_the_card():
    """Without ``device`` every G2 entry point runs on the card; where there
    is none it raises instead of carrying on on the CPU."""
    from tpu_ec_torch.curves import PointOps
    from tpu_ec_torch.errors import DeviceError
    from tpu_ec_torch.fields import Fp2Ops
    from tpu_ec_torch.ops.ec_fft import EcFftKernel
    from tpu_ec_torch.ops.pipeline import CommitPipeline

    makers = (lambda: PointOps(BLS12_381_G2), lambda: Fp2Ops(BLS12_381_G2.base),
              lambda: MultiexpKernel(BLS12_381_G2), lambda: EcFftKernel(BN254_G2),
              lambda: CommitPipeline(BLS12_381_G2))
    if torch.cuda.is_available():
        assert all(make().device.type == "cuda" for make in makers)
        return
    for make in makers:
        with pytest.raises(DeviceError, match="device='cpu'"):
            make()
