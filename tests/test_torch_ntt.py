"""The port's NTT against tpu_ec, bit-exact.

The digit-matmul NTT (int8 leaf GEMMs and kernel K2's plain version) against
``tpu_ec.ops.ntt_digit.digit_ntt_planes(interpret=True)`` at 2^10 and 2^12 on
BLS12-381 Fr, and ``FftKernel.radix_fft`` against the bigint ``ntt_ref`` at
2^4, which takes the Pease route.  Tolerance: none (integers).
"""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax.numpy as jnp
import numpy as np

from tpu_ec.fields import field_ops as j_field_ops
from tpu_ec.fields import params as jfp
from tpu_ec.ops.ntt_digit import digit_ntt_planes as j_digit_ntt_planes
from tpu_ec_torch.convert import limbs_to_numpy, limbs_to_torch
from tpu_ec_torch.fields import FieldOps
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.ops.ntt import FftKernel, ntt_ref
from tpu_ec_torch.ops.ntt_digit import digit_ntt_planes


def _mont_inputs(log_n, seed):
    spec = jfp.BLS12_381_FR
    rng = random.Random(seed)
    vals = [rng.randrange(spec.modulus) for _ in range(1 << log_n)]
    vals[:3] = [0, 1, spec.modulus - 1]
    return vals, np.asarray(j_field_ops(spec).from_ints(vals))  # (n, 16) Montgomery


@pytest.mark.parametrize("log_n,inverse", [(10, False), (12, False), (10, True)])
def test_digit_ntt_matches_tpu_ec(log_n, inverse):
    _, x = _mont_inputs(log_n, 100 + log_n)
    planes = np.ascontiguousarray(x.T)  # (16, n)
    want = np.asarray(
        j_digit_ntt_planes(jfp.BLS12_381_FR, jnp.asarray(planes), inverse, interpret=True)
    )
    got = digit_ntt_planes(tfp.BLS12_381_FR, limbs_to_torch(planes, "cpu"), inverse)
    assert np.array_equal(limbs_to_numpy(got), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_radix_fft_pease_route_vs_ntt_ref(inverse):
    vals, x = _mont_inputs(4, 7)
    f = FieldOps(tfp.BLS12_381_FR, "cpu")
    y = FftKernel(tfp.BLS12_381_FR, "cpu").radix_fft(limbs_to_torch(x, "cpu"), inverse=inverse)
    assert f.to_ints(y) == ntt_ref(tfp.BLS12_381_FR, vals, inverse=inverse)


def test_radix_fft_digit_route_roundtrip():
    """radix_fft at 2^10 takes the digit route on every device; forward
    then inverse returns the input."""
    _, x = _mont_inputs(10, 9)
    k = FftKernel(tfp.BLS12_381_FR, "cpu")
    tx = limbs_to_torch(x, "cpu")
    assert torch.equal(k.radix_fft(k.radix_fft(tx), inverse=True), tx)


@pytest.fixture
def fused_route():
    """Select the fused route (config ntt_impl) for one test."""
    from tpu_ec_torch.config import get_config

    cfg = get_config()
    saved = (cfg.ntt_impl, cfg.ntt_leaf_log)
    cfg.ntt_impl = "fused"
    yield cfg
    cfg.ntt_impl, cfg.ntt_leaf_log = saved


@pytest.mark.parametrize("log_n", [10, 12])
@pytest.mark.parametrize("leaf", [5, 8])
def test_fused_route_matches_tpu_ec_and_digit(fused_route, log_n, leaf):
    """The fused route (K4 leaves, K1 twiddles) against tpu_ec's FftKernel
    (its jnp Pease path on the CPU) and the port's digit route, forward and
    inverse."""
    from tpu_ec.ops.ntt import FftKernel as JFftKernel

    fused_route.ntt_leaf_log = leaf
    _, x = _mont_inputs(log_n, 200 + log_n)
    tx = limbs_to_torch(x, "cpu")
    got = [FftKernel(tfp.BLS12_381_FR, "cpu").radix_fft(tx, inverse=inv) for inv in (False, True)]
    fused_route.ntt_impl = "digit"
    digit = [FftKernel(tfp.BLS12_381_FR, "cpu").radix_fft(tx, inverse=inv) for inv in (False, True)]
    for g, d, inv in zip(got, digit, (False, True)):
        want = np.asarray(JFftKernel(jfp.BLS12_381_FR).radix_fft(jnp.asarray(x), inverse=inv))
        assert np.array_equal(limbs_to_numpy(g), want)
        assert torch.equal(g, d)


@pytest.mark.parametrize("log_n", [4, 9])
def test_pease_stage_plain_matches_pallas_interpret(log_n):
    """The Pease route, one K5 plain stage per stage, against tpu_ec's
    staged Pallas NTT in interpret mode (as tests/test_pallas_ntt.py runs
    it), forward and inverse."""
    from tpu_ec.ops.pallas.ntt import PallasFftKernel

    _, x = _mont_inputs(log_n, 300 + log_n)
    jk = PallasFftKernel(jfp.BLS12_381_FR, block=128, interpret=True)
    tk = FftKernel(tfp.BLS12_381_FR, "cpu")
    for inv in (False, True):
        want = np.asarray(jk.radix_fft(jnp.asarray(x), inverse=inv))
        assert np.array_equal(limbs_to_numpy(tk.radix_fft(limbs_to_torch(x, "cpu"), inverse=inv)), want)


def test_leaf_plain_matches_pallas_leaf_interpret():
    """K4's plain version (with the un-reversing gather) against tpu_ec's
    ``_leaf_apply`` in interpret mode: log_m 3, B = 8 columns."""
    from tpu_ec.ops.pallas.ntt_fused import FusedDomain as JFusedDomain, _leaf_apply
    from tpu_ec_torch.kernels.ntt_leaf import ntt_leaf_plain
    from tpu_ec_torch.ops.ntt_fused import FusedDomain

    _, x = _mont_inputs(6, 400)  # 64 values as (m = 8, B = 8)
    jdom = JFusedDomain(jfp.BLS12_381_FR, 3, False, leaf=3)
    tdom = FusedDomain(tfp.BLS12_381_FR, 3, False, 3)
    assert np.array_equal(tdom.leaf_tw[3], np.transpose(jdom._leaf_tw[3], (0, 2, 1)))
    rows = x.reshape(8, 8, 16)  # (m, B, L)
    want = np.asarray(_leaf_apply(jdom, jnp.asarray(np.transpose(rows, (2, 0, 1))), 3, True))
    got = ntt_leaf_plain(tfp.BLS12_381_FR, limbs_to_torch(rows, "cpu"), limbs_to_torch(tdom.leaf_tw[3], "cpu"))
    assert np.array_equal(limbs_to_numpy(got), np.transpose(want, (1, 2, 0)))


def test_radix_fft_many_mul_by_field_and_functional_api():
    from tpu_ec_torch.ops.ntt import intt, ntt

    _, x = _mont_inputs(8, 500)
    xs = limbs_to_torch(x[: 3 * 64].reshape(3, 64, 16), "cpu")
    k = FftKernel(tfp.BLS12_381_FR, "cpu")
    for inv in (False, True):
        many = k.radix_fft_many(xs, inverse=inv)
        assert all(torch.equal(many[i], k.radix_fft(xs[i], inverse=inv)) for i in range(3))
    assert all(torch.equal(a, b) for a, b in zip(k.radix_fft_many(list(xs)), k.radix_fft_many(xs)))
    f = FieldOps(tfp.BLS12_381_FR, "cpu")
    assert f.to_ints(k.mul_by_field(xs[0], 7)) == [(7 * v) % tfp.BLS12_381_FR.modulus for v in f.to_ints(xs[0])]
    assert torch.equal(intt(tfp.BLS12_381_FR, ntt(tfp.BLS12_381_FR, xs[1])), xs[1])
