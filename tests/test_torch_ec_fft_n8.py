"""The port's EC-group FFT against tpu_ec's at BN254 n = 8.

Bit for bit in Jacobian limbs against ``tpu_ec.ops.ec_fft.EcFftKernel``
(its jnp path), and affine against the oracle through the NTT's linearity
(see test_torch_ec_fft.py, whose helper this uses).  The inputs P_j = c_j G
hold a repeated pair (a == b: the sub leaves a garbage identity, z = 0 with
x, y != 0, which the next stage's chain doubles on), a negated pair
(a == -b) and an identity row.  Inputs come from oracle seeds; tolerance:
none (integers).
"""

import random

import pytest

pytest.importorskip("torch")

from tpu_ec.curves.params import BN254_G1 as J_BN

from test_torch_ec_fft import check_against_tpu_ec


def test_radix_ec_fft_n8_matches_tpu_ec():
    r = J_BN.scalar.modulus
    rng = random.Random(62)
    c = [rng.randrange(r) for _ in range(8)]
    c[4] = c[0]  # (0, 4): a == b
    c[5] = r - c[1]  # (1, 5): a == -b
    c[2] = 0  # row 2: the identity
    check_against_tpu_ec(c)
