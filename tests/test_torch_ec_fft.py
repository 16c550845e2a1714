"""The port's EC-group FFT (ops/ec_fft.py) against tpu_ec's, at BN254 n = 4.

- ``EcDomain`` tables (plain twiddle scalars, n^-1, the bit reversal)
  equal to tpu_ec's at log_n 1..11, both directions (numpy only);
- ``EcFftKernel.radix_ec_fft`` at n = 4 bit for bit against
  ``tpu_ec.ops.ec_fft.EcFftKernel`` (its jnp path), in Jacobian limbs.  The
  inputs are P_j = c_j G with a negated pair (a == -b: the butterfly's sub
  doubles, its add leaves a garbage identity) and an identity row; the
  affine result also equals the oracle's through the NTT's linearity,
  FFT(c G)_k = NTT(c)_k G (tests/test_ec_fft.py's check).

The n = 8 transform is in test_torch_ec_fft_n8.py, the inverse and the
batched forms in test_torch_ec_fft_many.py.  Inputs come from oracle seeds;
tolerance: none (integers).
"""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BN254_G1 as J_BN
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec.ops.ec_fft import EcFftKernel as JEcFftKernel
from tpu_ec.ops.ec_fft import get_ec_domain as j_get_ec_domain
from tpu_ec.ops.ntt import ntt_ref
from tpu_ec_torch.convert import points_to_numpy, points_to_torch
from tpu_ec_torch.curves import BN254_G1, PointOps
from tpu_ec_torch.ops.ec_fft import EcFftKernel, get_ec_domain


@pytest.mark.parametrize("log_n", range(1, 12))
def test_ec_domain_tables_match_tpu_ec(log_n):
    for inverse in (False, True):
        want = j_get_ec_domain(J_BN, log_n, inverse)
        got = get_ec_domain(BN254_G1, log_n, inverse)
        assert got.twiddle_scalars.dtype == np.uint32
        assert np.array_equal(got.twiddle_scalars, np.asarray(want.twiddle_scalars))
        assert np.array_equal(got.n_inv_scalar, np.asarray(want.n_inv_scalar))
        assert np.array_equal(got.rev, np.asarray(want._rev))


def check_against_tpu_ec(coeffs):
    """radix_ec_fft of P_j = c_j G: the port's Jacobian limbs equal tpu_ec's,
    and the affine points equal NTT(c)_k G."""
    jops = j_point_ops(J_BN)
    g = oracle.generator(J_BN)
    P = jops.to_jacobian(jops.from_affine_ints([oracle.scalar_mul(J_BN, g, c) for c in coeffs]))
    want = JEcFftKernel(J_BN).radix_ec_fft(P)
    ops = PointOps(BN254_G1, "cpu")
    got = EcFftKernel(BN254_G1, "cpu").radix_ec_fft(points_to_torch(tuple(map(np.asarray, P)), "cpu"))
    assert all(np.array_equal(a, np.asarray(b)) for a, b in zip(points_to_numpy(got), want)), "Jacobian limbs"
    expected = [oracle.scalar_mul(J_BN, g, c) for c in ntt_ref(J_BN.scalar, coeffs)]
    assert ops.to_affine_ints(ops.to_affine(got)) == expected, "affine vs the oracle"


def test_radix_ec_fft_n4_matches_tpu_ec():
    r = J_BN.scalar.modulus
    c = random.Random(60).randrange(r)
    # rows (0, 2) a negated pair, (1, 3) the identity and a point
    check_against_tpu_ec([c, 0, r - c, random.Random(61).randrange(r)])


def test_radix_ec_fft_rejects_other_sizes():
    z = torch.zeros((3, 16), dtype=torch.int64)
    with pytest.raises(ValueError, match="power of two"):
        EcFftKernel(BN254_G1, "cpu").radix_ec_fft((z, z, z))
