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
    got = digit_ntt_planes(tfp.BLS12_381_FR, limbs_to_torch(planes), inverse)
    assert np.array_equal(limbs_to_numpy(got), want)


@pytest.mark.parametrize("inverse", [False, True])
def test_radix_fft_pease_route_vs_ntt_ref(inverse):
    vals, x = _mont_inputs(4, 7)
    f = FieldOps(tfp.BLS12_381_FR)
    y = FftKernel(tfp.BLS12_381_FR).radix_fft(limbs_to_torch(x), inverse=inverse)
    assert f.to_ints(y) == ntt_ref(tfp.BLS12_381_FR, vals, inverse=inverse)


def test_radix_fft_digit_route_roundtrip():
    """radix_fft at 2^10 takes the digit route on every device; forward
    then inverse returns the input."""
    _, x = _mont_inputs(10, 9)
    k = FftKernel(tfp.BLS12_381_FR)
    tx = limbs_to_torch(x)
    assert torch.equal(k.radix_fft(k.radix_fft(tx), inverse=True), tx)
