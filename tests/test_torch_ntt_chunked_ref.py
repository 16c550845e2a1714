"""The port's chunked digit NTT against the benchmark's blocked plain
reference (``benchmark/reference/ntt.py``), bit-exact, and the chunk spans.

``FftKernel.radix_fft`` runs on the chunked route at 2^12 .. 2^14 with the
module's thresholds lowered here by monkeypatch (``_CHUNK_MIN`` 2^12,
``_DEVICE_TABLE_MIN`` 2^8, the chunk count where a test says) and the leaf
at 2^4, the domain cache cleared, so that the levels take the routes a
2^27 transform takes on the defaults: the first from factored seeds, the
next with a table built with K1, one below with a host table (2^14), every
GEMM in slices and K2's int8 entry in the final pass.  Inputs are seeded
Montgomery elements; tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from torch.profiler import ProfilerActivity, profile

from benchmark.program import generator, limbs_below
from benchmark.reference.limbs import LimbField
from benchmark.reference.ntt import ntt as reference_ntt
from benchmark.reference.params import CURVES
from tpu_ec_torch.config import get_config
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.ops import ntt_digit as tnd
from tpu_ec_torch.ops.ntt import FftKernel
from tpu_ec_torch.utils import timer

LEAF = 4
CHUNK_SPANS = ("ntt/chunk/seeds", "ntt/chunk/row", "ntt/chunk/leaf_mm", "ntt/chunk/inter_twiddle")


@pytest.fixture
def chunked(request, monkeypatch):
    """The chunked route from 2^12 at leaf 2^4, in ``request.param`` slices
    (16 otherwise); the tables off the disk cache."""
    chunks = getattr(request, "param", 16)
    monkeypatch.setattr(tnd, "_CHUNK_MIN", 1 << 12)
    monkeypatch.setattr(tnd, "_DEVICE_TABLE_MIN", 1 << 8)
    monkeypatch.setattr(tnd, "_CHUNK_COUNT", chunks)
    cfg = get_config()
    monkeypatch.setattr(cfg, "ntt_digit_leaf_log", LEAF)
    monkeypatch.setattr(cfg, "cache", False)
    tnd._digit_domain.cache_clear()
    yield chunks
    tnd._digit_domain.cache_clear()


def _inputs(log_n, seed):
    """2^log_n seeded Montgomery elements of BLS12-381 Fr as (n, 16) int64 limbs."""
    return limbs_below(generator(seed, "cpu"), (1 << log_n,), CURVES["bls12_381_g1"].r, 16, "cpu")


def _reference(x, log_n, inverse):
    c = CURVES["bls12_381_g1"]
    return reference_ntt(LimbField(c.r, 16), x, c.root_of_unity(log_n), inverse, block=1 << 8)


@pytest.mark.parametrize("log_n,chunked", [(12, 16), (12, 4), (13, 16), (14, 16), (14, 4)],
                         indirect=["chunked"])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_chunked_radix_fft_matches_the_blocked_reference(chunked, log_n, inverse):
    dom = tnd.get_digit_domain(tfp.BLS12_381_FR, log_n, inverse, LEAF)
    routes = [v if isinstance(v, str) else "host" for v in dom.inter.values()]
    assert routes[0] == "factored" and routes[1] == "device"
    assert log_n < 14 or routes[2] == "host"
    x = _inputs(log_n, 1000 * log_n + chunked)
    got = FftKernel(tfp.BLS12_381_FR, "cpu").radix_fft(x, inverse=inverse)
    assert torch.equal(got, _reference(x, log_n, inverse))


@pytest.mark.parametrize("chunked", [4], indirect=True)
def test_chunk_spans_under_the_profiler(chunked):
    """Under torch.profiler the inverse at 2^12 in 4 slices opens, inside
    ``ntt/chunked_level``: one ``ntt/chunk/seeds`` (the factored level's
    base rows), a ``ntt/chunk/row`` a slice of that level, and a
    ``ntt/chunk/leaf_mm`` and a ``ntt/chunk/inter_twiddle`` a slice of
    both chunked levels."""
    log_n = 12
    kern = FftKernel(tfp.BLS12_381_FR, "cpu")
    x = _inputs(log_n, 7)
    kern.radix_fft(x, inverse=True)  # builds the domain and its tables
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        kern.radix_fft(x, inverse=True)
    spans = []
    for e in prof.events():
        if e.name.startswith(timer.PREFIX + "ntt/chunk/"):
            parent = e.cpu_parent
            while parent is not None and not parent.name.startswith(timer.PREFIX):
                parent = parent.cpu_parent
            spans.append((e.name[len(timer.PREFIX):], parent.name[len(timer.PREFIX):]))
    counts = {lab: sum(1 for s, _ in spans if s == lab) for lab in CHUNK_SPANS}
    assert counts == {"ntt/chunk/seeds": 1, "ntt/chunk/row": 4, "ntt/chunk/leaf_mm": 8,
                      "ntt/chunk/inter_twiddle": 8}
    assert {up for _, up in spans} == {"ntt/chunked_level"}


@pytest.mark.parametrize("chunked", [4], indirect=True)
@pytest.mark.parametrize("B", [2, 3])
@pytest.mark.parametrize("inverse", [True, False], ids=["inverse", "forward"])
def test_chunked_batch_matches_the_blocked_reference(chunked, B, inverse):
    """``digit_ntt_planes_batch`` of B transforms of 2^12 on the chunked
    route (its first operand split from limb planes, words of B digits or
    plain bytes in its first transposing copy): each transform equals the
    reference's, and each of its 12 leaf GEMMs (two levels of 4 slices, a
    final pass of 4) reads a K-major operand."""
    log_n = 12
    xs = [_inputs(log_n, 50 * B + b) for b in range(B)]
    xpb = torch.stack([x.T for x in xs], dim=-1)  # (16, n, B) planes
    before = tnd.leaf_mm_counts()
    got = tnd.digit_ntt_planes_batch(tfp.BLS12_381_FR, xpb, inverse, leaf=LEAF)
    after = tnd.leaf_mm_counts()
    assert after["k_major"] - before["k_major"] == 12 and after["n_major"] == before["n_major"]
    for b, x in enumerate(xs):
        assert torch.equal(got[:, :, b].T, _reference(x, log_n, inverse))
