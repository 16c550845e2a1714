"""The port's spans (``tpu_ec_torch/utils/timer.py``): with no profiler and
config ``timer`` off a span is a flag test; under torch.profiler every
entry point's stage spans nest under its entry span, one round span a
round; with ``timer`` on, ``report()`` gives count, host ms and device ms.

K3's plain versions are replaced by stand-ins that return zeros of the
right shapes: the spans depend on the shapes alone, and the values are the
other tests' subject (under the profiler the plain point ops' thousands of
small tensor ops would take minutes)."""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from torch.profiler import ProfilerActivity, profile

from tpu_ec_torch import curves
from tpu_ec_torch.config import get_config
from tpu_ec_torch.kernels import point as kpoint
from tpu_ec_torch.ops import msm as tmsm
from tpu_ec_torch.ops import ntt as tntt
from tpu_ec_torch.ops import ntt_digit as tnd
from tpu_ec_torch.ops.ec_fft import EcFftKernel
from tpu_ec_torch.ops.msm import MultiexpKernel
from tpu_ec_torch.ops.pipeline import CommitPipeline
from tpu_ec_torch.utils import timer

N = 16  # points of each MSM and commit
FFT_LOG = 3  # EC-FFT size 2^3


@pytest.fixture
def stand_ins(monkeypatch):
    """K3's plain versions as zeros of their outputs' shapes; the digit NTT
    at 2^4 with two levels of 2^2, its tables off the disk cache."""
    zeros = lambda coords: tuple(torch.zeros_like(coords[0]) for _ in range(3))
    monkeypatch.setattr(kpoint, "point_op_plain", lambda spec, op, coords, keep=None, ext=1: zeros(coords))
    monkeypatch.setattr(kpoint, "horner_plain",
                        lambda spec, partials, w, ext=1: zeros([c[0] for c in kpoint._chunk_axis(partials)]))
    monkeypatch.setattr(kpoint, "ec_fft_stage_plain", lambda spec, coords, tw, s, ext=1: zeros(coords))
    monkeypatch.setattr(kpoint, "scalar_mul_plain", lambda spec, coords, k, ext=1: zeros(coords))
    cfg = get_config()
    monkeypatch.setattr(cfg, "cache", False)
    monkeypatch.setattr(cfg, "ntt_digit_leaf_log", 2)
    monkeypatch.setattr(tntt, "DIGIT_MIN_LOG", 2)


@pytest.fixture
def timing():
    timer.STATS.reset()
    was = timer.enabled()
    yield
    timer.enable(was)
    timer.STATS.reset()


def _points(ops, n):
    """n affine points (the generator's limbs: the stand-ins ignore values)."""
    x, y = ops.generator_affine
    return x.expand(n, -1).contiguous(), y.expand(n, -1).contiguous()


def _scalars(n):
    s = torch.zeros((n, 16), dtype=torch.int64)
    s[:, 0] = torch.arange(1, n + 1) * 4099 % 65536
    s[:, 3] = torch.arange(n) * 31 + 7
    return s


def _commit():
    pipe = CommitPipeline(curves.BN254_G1, "cpu")
    coeffs, bases = pipe.fr.to_mont(_scalars(N)), _points(pipe.ops, N)
    return lambda: pipe.commit(coeffs, bases)


def _msm(spec, window, method="auto"):
    kern = MultiexpKernel(spec, "cpu")
    bases, s = _points(kern.ops, N), _scalars(N)
    return lambda: kern.multiexp(bases, s, window_size=window, method=method)


def _batch(monkeypatch, chunks=4, w=3):
    """multiple_multiexp of ``chunks`` MSMs, the budget cut to two chunks a slab."""
    spec = curves.BN254_G1
    kern = MultiexpKernel(spec, "cpu")
    chunk = N // chunks
    budget = next(1 << k for k in range(10, 40)
                  if tmsm.batch_slab(spec, "pair", chunk, w, "cpu", hbm_budget_bytes=1 << k) == 2)
    monkeypatch.setattr(get_config(), "msm_hbm_budget_bytes", budget)
    bases, s = _points(kern.ops, N), _scalars(N)
    return lambda: kern.multiple_multiexp(bases, s, chunks, window_size=w)


def _ec_fft(inverse):
    kern = EcFftKernel(curves.BN254_G1, "cpu")
    P = kern.ops.to_jacobian(_points(kern.ops, 1 << FFT_LOG))
    if inverse:
        return lambda: kern.radix_ec_fft(P, inverse=True)
    return lambda: kern.radix_ec_fft_many([P, P])


def _spans(prof):
    """(label, labels of its enclosing spans, innermost first) of every span."""
    out = []
    for e in prof.events():
        if e.name.startswith(timer.PREFIX):
            up, p = [], e.cpu_parent
            while p is not None:
                if p.name.startswith(timer.PREFIX):
                    up.append(p.name[len(timer.PREFIX):])
                p = p.cpu_parent
            out.append((e.name[len(timer.PREFIX):], up))
    return out


PAIR = ["msm/digits", "msm/pair/rows", "msm/pair/round", "msm/pair/survivors", "msm/pair/scatter", "msm/tail",
        "msm/horner"]
# entry -> (entry span, its stage spans, {a stage span: its count}); the batch:
# two slabs of two chunks of 4 points, 8 rows and 3 pair rounds a slab
CASES = {
    "commit": ("commit", ["ntt", "from_mont", "msm", "ntt/split_rows", "ntt/leaf_mm",
                          "ntt/inter_twiddle", "ntt/transpose", *PAIR],
               {"ntt/transpose": 1, "ntt/leaf_mm": 2, "msm/pair/round": 4}),
    "msm_pair": ("msm", PAIR, {"msm/pair/round": 4, "msm/horner": 1}),
    "msm_g2_pair": ("msm", PAIR, {"msm/pair/round": 4, "msm/horner": 1}),
    "msm_g2_scan": ("msm", ["msm/digits", "msm/scan/rows", "msm/scan/round", "msm/scan/scatter", "msm/tail",
                            "msm/horner"], {"msm/scan/round": (N - 1).bit_length(), "msm/tail": 1}),
    "msm_batch": ("msm_batch", ["msm_batch/slab_size", "msm_batch/slab", "msm_batch/cat", *PAIR],
                  {"msm_batch/slab": 2, "msm/pair/round": 2 * 3, "msm/horner": 2}),
    "ec_fft": ("ec_fft", ["ec_fft/stage", "ec_fft/bit_reverse"], {"ec_fft/stage": FFT_LOG, "ec_fft/bit_reverse": 1}),
    "ec_fft_inverse": ("ec_fft", ["ec_fft/stage", "ec_fft/bit_reverse", "ec_fft/scale"],
                       {"ec_fft/stage": FFT_LOG, "ec_fft/scale": 1}),
}


def _entry(name, monkeypatch):
    return {"commit": _commit, "msm_pair": lambda: _msm(curves.BN254_G1, 4),
            "msm_g2_pair": lambda: _msm(curves.BN254_G2, 4),
            "msm_g2_scan": lambda: _msm(curves.BN254_G2, 4, "scan"), "msm_batch": lambda: _batch(monkeypatch),
            "ec_fft": lambda: _ec_fft(False), "ec_fft_inverse": lambda: _ec_fft(True)}[name]()


def test_span_off_is_a_flag_test(stand_ins, timing, monkeypatch):
    """No profiler, timer off: a span never opens a profiler range nor a
    CUDA event, and records nothing, in an entry point's own spans too."""
    def refuse(*a, **kw):
        raise AssertionError("a span off opened a range")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    monkeypatch.setattr(torch.cuda, "Event", refuse)
    timer.enable(False)
    with timer.phase("off", n=1):
        pass
    _ec_fft(True)()
    _msm(curves.BN254_G1, 4)()
    assert dict(timer.STATS.records) == {}


@pytest.mark.parametrize("name", list(CASES))
def test_entry_stage_spans_nest(name, stand_ins, timing, monkeypatch):
    """Under the profiler: one entry span, its stages inside it (commit's
    NTT, from_mont and MSM; every engine's digits, rows, rounds, tail and
    Horner), one round span a round: the pair engine log2(rows) rounds, the
    scan (n - 1).bit_length(), the EC-FFT log2(n) stages.  A warm call
    builds nothing."""
    timer.enable(False)
    call = _entry(name, monkeypatch)
    call()  # builds the caches
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    entry, stages, counts = CASES[name]
    spans = _spans(prof)
    assert [lab for lab, up in spans if not up] == [entry]
    found = {lab for lab, _ in spans}
    assert set(stages) <= found and not any(lab.startswith("build/") for lab in found)
    for lab, up in spans:
        if lab != entry:
            assert up[-1] == entry, (lab, up)
    for lab, k in counts.items():
        assert sum(1 for s, _ in spans if s == lab) == k, lab
    if name == "msm_g2_pair":  # G2's "auto" runs the pair engine, none of the scan's stages
        assert not any(lab.startswith("msm/scan/") for lab in found)
    if name == "commit":  # the engine's spans inside the MSM's; its negation's borrow test inside the rows
        assert all(up[0] == "msm" for lab, up in spans if lab == "msm/pair/round")
        assert any(lab == "wait/borrow_test" and up[0] == "msm/pair/rows" for lab, up in spans)


def test_span_args_and_builds(stand_ins, timing, monkeypatch):
    """An entry span hands its arguments to the profiler's range as one
    string; a cold cache shows as build spans (the EC-FFT's domain, its
    field domain and its tensors), inside the entry span."""
    timer.enable(False)
    from tpu_ec_torch.ops import ec_fft as tef

    tntt.get_domain.cache_clear()
    tef.get_ec_domain.cache_clear()
    call = _ec_fft(False)  # a new kernel: its tensors are not built yet
    real, opened = torch.profiler.record_function, []

    def recording(name, args=None):
        opened.append((name, args))
        return real(name, args)

    monkeypatch.setattr(torch.profiler, "record_function", recording)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        call()
    spans = _spans(prof)
    builds = {lab: up for lab, up in spans if lab.startswith("build/")}
    assert set(builds) == {"build/ec_domain_tensors", "build/ec_domain", "build/ntt_domain"}
    assert all(up[-1] == "ec_fft" for up in builds.values())
    assert (timer.PREFIX + "ec_fft", f"curve={curves.BN254_G1.name} n={1 << FFT_LOG} batch=2 inverse=False") in opened
    assert (timer.PREFIX + "ec_fft/stage", None) in opened


def test_timer_report_counts_host_and_device(stand_ins, timing):
    """Timer on: nested labels, count and host ms per label; device ms null
    where no CUDA event was recorded."""
    timer.enable()
    _ec_fft(True)()
    summary = timer.summary()
    assert summary["ec_fft"]["count"] == 1 and summary["ec_fft/ec_fft/stage"]["count"] == FFT_LOG
    assert summary["ec_fft/ec_fft/scale"]["count"] == 1
    assert all(s["device_ms"] is None and s["total_s"] >= 0 for s in summary.values())
    lines = timer.report().splitlines()
    assert any(ln.startswith("ec_fft: n=1 total=") and ln.endswith("device=null") for ln in lines)


def test_digit_ntt_planes_spans(stand_ins, timing):
    """The digit NTT's plane entries split under their own span name."""
    timer.enable()
    spec = curves.BN254_G1.scalar
    xp = torch.zeros((spec.n_limbs, 16), dtype=torch.int64)
    tnd.digit_ntt_planes(spec, xp)
    summary = timer.summary()
    assert summary["ntt/split_digits"]["count"] == 1 and summary["ntt/leaf_mm"]["count"] == 2
