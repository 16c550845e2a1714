"""The port's digit NTT on its large-size routes against tpu_ec, bit-exact.

Both packages' thresholds are forced down together, as
tests/test_ntt_digit.py forces tpu_ec's (``_CHUNK_MIN`` 2^9,
``_DEVICE_TABLE_MIN`` 2^8, both domain caches cleared), so that a 2^10 or
2^12 transform at leaf 4 takes the routes of 2^22 .. 2^26: factored seeds
with chunked levels, a Bailey table built with K1 (its plain version here),
the chunked last GEMM and K2's int8-digit entry in the final pass.  Inputs
come from numpy seeds; tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax.numpy as jnp
import numpy as np

import tpu_ec.ops.ntt_digit as jnd
import tpu_ec_torch.ops.ntt_digit as tnd
from tpu_ec.fields import field_ops as j_field_ops
from tpu_ec.fields import params as jfp
from tpu_ec.ops.ntt import get_domain as j_get_domain
from tpu_ec_torch.convert import limbs_to_numpy, limbs_to_torch
from tpu_ec_torch.fields import FieldOps
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.kernels.inter import inter_twiddle_plain
from tpu_ec_torch.ops.ntt import FftKernel, ntt_ref

FIELDS = ["BLS12_381_FR", "BN254_FR"]


@pytest.fixture
def small_thresholds(request, monkeypatch):
    """Both packages' thresholds forced down together, and the chunk count
    where a test parametrises it (16 otherwise): with 4 chunks a 16-row
    level has slices of 4 rows, so the base doubling and the products of
    the seeds run too."""
    chunks = getattr(request, "param", 16)
    for mod in (jnd, tnd):
        monkeypatch.setattr(mod, "_CHUNK_MIN", 1 << 9)
        monkeypatch.setattr(mod, "_DEVICE_TABLE_MIN", 1 << 8)
        monkeypatch.setattr(mod, "_CHUNK_COUNT", chunks)
    jnd.get_digit_domain.cache_clear()
    tnd._digit_domain.cache_clear()
    yield chunks
    jnd.get_digit_domain.cache_clear()
    tnd._digit_domain.cache_clear()


def _values(name, n, seed):
    """n field elements from a numpy seed, the first three 0, 1 and p - 1;
    their Montgomery (n, 16) limbs from tpu_ec."""
    spec = getattr(jfp, name)
    rng = np.random.default_rng(seed)
    vals = [int.from_bytes(rng.bytes(40), "little") % spec.modulus for _ in range(n)]
    vals[:3] = [0, 1, spec.modulus - 1]
    return vals, np.asarray(j_field_ops(spec).from_ints(vals))


@pytest.mark.parametrize("name,log_n,small_thresholds", [
    *((name, log_n, 16) for name in FIELDS for log_n in (10, 12)), ("BLS12_381_FR", 12, 4),
], indirect=["small_thresholds"])
def test_chunked_routes_match_tpu_ec_and_ntt_ref(small_thresholds, name, log_n):
    vals, x = _values(name, 1 << log_n, 10 * log_n + len(name))
    planes = np.ascontiguousarray(x.T)
    tspec = getattr(tfp, name)
    f = FieldOps(tspec, "cpu")
    dom = tnd.get_digit_domain(tspec, log_n, False, 4)
    assert dom.inter[(log_n, log_n - 4)] == "factored"
    assert log_n == 10 or dom.inter[(8, 4)] == "device"
    for inverse in (False, True):
        want = np.asarray(jnd.digit_ntt_planes(getattr(jfp, name), jnp.asarray(planes), inverse, leaf=4,
                                               interpret=True))
        got = tnd.digit_ntt_planes(tspec, limbs_to_torch(planes, "cpu"), inverse, leaf=4)
        assert np.array_equal(limbs_to_numpy(got), want)
        assert f.to_ints(got.T) == ntt_ref(tspec, vals, inverse=inverse)


@pytest.mark.parametrize("chunk_min", [1 << 9, 1 << 25], ids=["chunked", "unchunked"])
def test_batch_matches_tpu_ec_and_single_transforms(monkeypatch, chunk_min):
    """(2^8, B = 3): 768 elements, chunked where the threshold is 2^9 (the
    2^8 level keeps a table built with K1's plain version and is sliced)."""
    for mod in (jnd, tnd):
        monkeypatch.setattr(mod, "_CHUNK_MIN", chunk_min)
        monkeypatch.setattr(mod, "_DEVICE_TABLE_MIN", 1 << 8)
    jnd.get_digit_domain.cache_clear()
    n, B = 1 << 8, 3
    _, x = _values("BLS12_381_FR", n * B, 77)
    xpb = np.ascontiguousarray(x.reshape(B, n, 16).transpose(2, 1, 0))  # (16, n, B)
    spec = tfp.BLS12_381_FR
    txb = limbs_to_torch(xpb, "cpu")
    try:
        for inverse in (False, True):
            want = np.asarray(jnd.digit_ntt_planes_batch(jfp.BLS12_381_FR, jnp.asarray(xpb), inverse, leaf=4,
                                                         interpret=True))
            got = tnd.digit_ntt_planes_batch(spec, txb, inverse, leaf=4)
            assert np.array_equal(limbs_to_numpy(got), want)
            for b in range(B):
                single = tnd.digit_ntt_planes(spec, txb[:, :, b].contiguous(), inverse, leaf=4)
                assert torch.equal(got[:, :, b], single)
        back = tnd.digit_ntt_planes_batch(spec, tnd.digit_ntt_planes_batch(spec, txb, leaf=4), True, leaf=4)
        assert torch.equal(back, txb)
    finally:
        jnd.get_digit_domain.cache_clear()


@pytest.mark.parametrize("canonical", [False, True], ids=["to_int8", "canonical"])
def test_inter_int8_entry_matches_tpu_ec(canonical):
    """K2's int8-digit input (the final pass after a chunked last GEMM)
    against tpu_ec's ``inter_twiddle`` on the same int8 digits."""
    rng = np.random.default_rng(11 + canonical)
    n = 300
    dig = rng.integers(0, 128, (37, n)).astype(np.int8)
    dig[:, 0] = 127  # the largest value, 2^259 - 1
    dig[:, 1] = 0
    c = tfp.BLS12_381_FR.modulus - 5
    t = np.asarray([(c >> (16 * i)) & 0xFFFF for i in range(16)], np.int64)
    want = np.asarray(jnd.inter_twiddle(jfp.BLS12_381_FR, jnp.asarray(dig), jnp.asarray(t.astype(np.uint32)),
                                        canonical=canonical, const_t=True, interpret=True))
    got = inter_twiddle_plain(tfp.BLS12_381_FR, torch.as_tensor(dig), torch.as_tensor(t),
                              canonical=canonical, const_t=True)
    assert got.dtype == (torch.int64 if canonical else torch.int8)
    assert np.array_equal(got.numpy().astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("log_n,log_m,log_n1,inverse", [(10, 10, 6, False), (12, 8, 4, True), (9, 9, 1, False)])
def test_device_table_matches_host_tables(name, log_n, log_m, log_n1, inverse):
    """``inter_table288_device`` (row doubling with K1's plain version) is the
    transpose of ``inter_table288_np`` of both packages."""
    tspec, jspec = getattr(tfp, name), getattr(jfp, name)
    omega = j_get_domain(jspec, log_n, inverse).omega
    got = tnd.inter_table288_device(tspec, omega, log_n, log_m, log_n1, "cpu")
    host = tnd.inter_table288_np(tspec, omega, log_n, log_m, log_n1)
    assert np.array_equal(jnd.inter_table288_np(jspec, omega, log_n, log_m, log_n1), host)
    assert np.array_equal(got.permute(2, 0, 1).numpy(), host.astype(np.int64))


@pytest.mark.parametrize("inverse", [False, True])
def test_factored_seeds_match_tpu_ec(small_thresholds, inverse):
    log_n, log_m, log_n1 = 12, 12, 8
    jdom = jnd.get_digit_domain(jfp.BLS12_381_FR, log_n, inverse, 4)
    tdom = tnd.get_digit_domain(tfp.BLS12_381_FR, log_n, inverse, 4)
    want = jnd._factored_seeds(jdom, log_m, log_n1, True)
    got = tnd._factored_seeds(tdom, log_m, log_n1, "cpu")
    assert len(got["cur_pows"]) == len(want["cur_pows"]) == log_m - log_n1
    for g, w in zip(got["cur_pows"], want["cur_pows"]):
        assert np.array_equal(g.T.numpy(), np.asarray(w).astype(np.int64))
    assert np.array_equal(got["c_row"].T.numpy(), np.asarray(want["c_row"]).astype(np.int64))


def test_radix_fft_chunked_route_matches_tpu_ec(small_thresholds):
    """``FftKernel.radix_fft`` at 2^10 on the chunked route (its (n, 16)
    rows in and out) against tpu_ec's ``FftKernel``, both directions."""
    from tpu_ec.ops.ntt import FftKernel as JFftKernel

    _, x = _values("BLS12_381_FR", 1 << 10, 5)
    k = FftKernel(tfp.BLS12_381_FR, "cpu")
    for inverse in (False, True):
        want = np.asarray(JFftKernel(jfp.BLS12_381_FR).radix_fft(jnp.asarray(x), inverse=inverse))
        got = k.radix_fft(limbs_to_torch(x, "cpu"), inverse=inverse)
        assert np.array_equal(limbs_to_numpy(got), want)
