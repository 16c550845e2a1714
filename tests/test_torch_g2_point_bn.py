"""The port's G2 point ops on BN254 against tpu_ec's PointOps (cases in
test_torch_g2_cases.py; the BLS12-381 twin is test_torch_g2_point_bls.py).

tpu_ec runs G2 on its jnp formulas (no Pallas kernel); the port runs K3's
plain version on the CPU.  Jacobian coordinates must be equal bit for bit;
tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import test_torch_g2_cases as cases
from tpu_ec.curves.params import BN254_G2 as J_G2
from tpu_ec_torch.curves import BN254_G2


@pytest.fixture(scope="module")
def batch():
    return cases.make_batch(J_G2, BN254_G2, seed=70)


def test_add(batch):
    cases.check_add(batch)


def test_add_mixed(batch):
    cases.check_add_mixed(batch)


def test_double_neg_sub(batch):
    cases.check_double_neg_sub(batch)


def test_eq_and_to_affine(batch):
    cases.check_eq_and_to_affine(batch)
