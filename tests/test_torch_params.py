"""The port's constants (tpu_ec_torch) against the JAX package's (tpu_ec).

Every FieldSpec and CurveSpec constant, and the digit-NTT DigitDomain
tables (leaf matrices, 2^288-scaled Bailey tables, final constant), must be
equal: the port builds its own so that it never imports jax.
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.curves import params as jcp
from tpu_ec.fields import params as jfp
from tpu_ec.ops import ntt_digit as jnd
from tpu_ec_torch.curves import params as tcp
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.ops import ntt_digit as tnd

FIELDS = ["BLS12_381_FR", "BLS12_381_FQ", "BN254_FR", "BN254_FQ"]
FIELD_ATTRS = [
    "name", "modulus", "generator", "n_limbs", "bits", "r", "one", "r2", "inv",
    "nprime", "inv32", "two_adicity", "quadratic_nonresidue", "root_of_unity",
]
LIMB_ATTRS = ["p_limbs", "one_limbs", "r2_limbs", "nprime_limbs"]


@pytest.mark.parametrize("name", FIELDS)
def test_field_spec_equal(name):
    j, t = getattr(jfp, name), getattr(tfp, name)
    for attr in FIELD_ATTRS:
        assert getattr(t, attr) == getattr(j, attr), attr
    for attr in LIMB_ATTRS:
        assert np.array_equal(getattr(t, attr), getattr(j, attr)), attr


@pytest.mark.parametrize("name", ["BLS12_381_G1", "BN254_G1"])
def test_curve_spec_equal(name):
    j, t = getattr(jcp, name), getattr(tcp, name)
    for attr in ("name", "ext", "b", "gen_x", "gen_y", "cofactor"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.base.modulus == j.base.modulus
    assert t.scalar.modulus == j.scalar.modulus


@pytest.mark.parametrize("log_n,inverse", [(10, False), (12, False), (10, True)])
def test_digit_domain_tables_equal(log_n, inverse):
    leaf = 8
    j = jnd.DigitDomain(jfp.BLS12_381_FR, log_n, inverse, leaf)
    t = tnd.DigitDomain(tfp.BLS12_381_FR, log_n, inverse, leaf)
    assert t.plan == j.plan and t.d_in == j.d_in and t.d_leaf == j.d_leaf
    assert t.omega == j.omega
    assert sorted(t.matrices) == sorted(j.matrices)
    for k in j.matrices:
        assert np.array_equal(t.matrices[k], j.matrices[k]), k
    assert sorted(t.inter) == sorted(j.inter)
    for k in j.inter:
        assert np.array_equal(t.inter[k], j.inter[k]), k
    assert np.array_equal(t.final_c, j.final_c)


def test_digit_domain_refuses_chunked_sizes(monkeypatch):
    """The port once refused domains of 2^25 and up; now such a domain takes
    tpu_ec's routes under tpu_ec's chunk threshold: the 2^25 level keeps
    factored seeds, below it K1 builds the tables (the host threshold
    lowered to 2^12 so that no host table is built here)."""
    for mod in (jnd, tnd):
        monkeypatch.setattr(mod, "_DEVICE_TABLE_MIN", 1 << 12)
        monkeypatch.setattr(mod, "_CHUNK_MIN", 1 << 25)
    j = jnd.DigitDomain(jfp.BLS12_381_FR, 25, False, 8)
    t = tnd.DigitDomain(tfp.BLS12_381_FR, 25, False, 8)
    assert t.plan == j.plan == [7, 6, 6, 6]
    assert t.inter == {(25, 18): "factored", (18, 12): "device", (12, 6): "device"}
    assert j.inter == {(25, 18): "factored", (18, 12): None, (12, 6): None}


@pytest.mark.parametrize("name", ["BLS12_381_G2", "BN254_G2"])
def test_g2_curve_spec_equal(name):
    j, t = getattr(jcp, name), getattr(tcp, name)
    for attr in ("name", "ext", "b", "gen_x", "gen_y", "cofactor"):
        assert getattr(t, attr) == getattr(j, attr), attr
    assert t.ext == 2 and t.base.modulus == j.base.modulus and t.scalar.modulus == j.scalar.modulus
    assert hash(t) == hash(j) and t in tcp.ALL_CURVES
    assert [c.name for c in tcp.ALL_CURVES] == [c.name for c in jcp.ALL_CURVES]
