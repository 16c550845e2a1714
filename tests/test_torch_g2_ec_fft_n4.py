"""The port's G2 EC-group FFT at BN254 n = 4 against tpu_ec's, bit for bit.

``EcFftKernel(BN254_G2).radix_ec_fft`` of P_j = c_j G2 with a negated pair
(a == -b: the butterfly's sub doubles, its add leaves a garbage identity)
and an identity row, against ``tpu_ec.ops.ec_fft.EcFftKernel`` (its jnp
path; tpu_ec's G2 reaches no Pallas kernel), in Jacobian coordinates.  The
port runs K3's plain version of its Fq2 stage and chain entries on the CPU.
The n = 8 transform, against the native EC-FFT, and G2 scalar_mul are in
test_torch_g2_scalar_mul_ec_fft.py.  Inputs from seeds; tolerance: none
(integers).
"""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BN254_G2 as J_BN
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec.ops.ec_fft import EcFftKernel as JEcFftKernel
from tpu_ec_torch.convert import g2_points_to_numpy, g2_points_to_torch
from tpu_ec_torch.curves import BN254_G2
from tpu_ec_torch.ops.ec_fft import EcFftKernel


def _same(got, want):
    return all(np.array_equal(g[k], np.asarray(w[k])) for g, w in zip(g2_points_to_numpy(got), want) for k in range(2))


def test_ec_fft_n4_matches_tpu_ec():
    r = J_BN.scalar.modulus
    c = random.Random(102).randrange(r)
    coeffs = [c, 0, r - c, random.Random(103).randrange(r)]  # a negated pair, the identity
    jops = j_point_ops(J_BN)
    g = oracle.generator(J_BN)
    P = jops.to_jacobian(jops.from_affine_ints([oracle.scalar_mul(J_BN, g, v) for v in coeffs]))
    want = JEcFftKernel(J_BN).radix_ec_fft(P)
    got = EcFftKernel(BN254_G2, "cpu").radix_ec_fft(g2_points_to_torch(tuple(tuple(map(np.asarray, x)) for x in P),
                                                                       "cpu"))
    assert _same(got, want)
