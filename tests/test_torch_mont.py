"""Port field ops and kernel K1's plain version against tpu_ec, bit-exact.

The same numpy inputs (from a seed, with the edge values 0, 1, p - 1) go
through tpu_ec's FieldOps (jnp) and the port's FieldOps on the CPU, which
runs K1's plain version for the products.  Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.fields import field_ops as j_field_ops
from tpu_ec.fields import params as jfp
from tpu_ec.ops.pallas.mont import mont_mul as j_pallas_mont_mul
from tpu_ec_torch.convert import limbs_to_numpy, limbs_to_torch
from tpu_ec_torch.fields import FieldOps
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.kernels.mont import mont_mul, mont_mul_plain

FIELDS = ["BLS12_381_FR", "BLS12_381_FQ", "BN254_FR", "BN254_FQ"]
BINARY = ["mul", "add", "sub"]
UNARY = ["sqr", "from_mont", "to_mont", "neg", "double"]


def _ints(spec, n, seed):
    rng = np.random.default_rng(seed)
    p = spec.modulus
    rand = [int.from_bytes(rng.bytes(64), "little") % p for _ in range(n - 5)]
    return [0, 1, p - 1, p - 2, (p - 1) // 2] + rand


def _pair(name, seed, n=48):
    spec = getattr(jfp, name)
    jf = j_field_ops(spec)
    a = np.asarray(jf.from_ints(_ints(spec, n, seed)))
    b = np.asarray(jf.from_ints(_ints(spec, n, seed + 1)[::-1]))
    return jf, FieldOps(getattr(tfp, name), "cpu"), a, b


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("op", BINARY)
def test_binary_op_matches_tpu_ec(name, op):
    jf, tf, a, b = _pair(name, 10)
    want = np.asarray(getattr(jf, op)(a, b))
    got = limbs_to_numpy(getattr(tf, op)(limbs_to_torch(a, "cpu"), limbs_to_torch(b, "cpu")))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", FIELDS)
@pytest.mark.parametrize("op", UNARY)
def test_unary_op_matches_tpu_ec(name, op):
    jf, tf, a, _ = _pair(name, 20)
    if op == "to_mont":  # to_mont takes plain values < p
        a = np.asarray(jf.from_ints(_ints(jf.spec, 48, 21), mont=False))
    want = np.asarray(getattr(jf, op)(a))
    got = limbs_to_numpy(getattr(tf, op)(limbs_to_torch(a, "cpu")))
    assert np.array_equal(got, want)


@pytest.mark.parametrize("name", FIELDS)
def test_mont_plain_matches_pallas_interpret(name):
    """K1's plain version against the Pallas kernel it replaces, run in
    interpret mode as tests/test_pallas_mont.py runs it."""
    spec = getattr(jfp, name)
    _, _, a, b = _pair(name, 30, n=24)
    want = np.asarray(j_pallas_mont_mul(spec, a, b, block=128, interpret=True))
    tspec = getattr(tfp, name)
    got = limbs_to_numpy(mont_mul_plain(tspec, limbs_to_torch(a, "cpu"), limbs_to_torch(b, "cpu")))
    assert np.array_equal(got, want)
    # the wrapper takes the plain version on CPU tensors
    assert np.array_equal(limbs_to_numpy(mont_mul(tspec, limbs_to_torch(a, "cpu"), limbs_to_torch(b, "cpu"))), want)


def test_inverse_and_ints_roundtrip():
    spec = tfp.BLS12_381_FQ
    f = FieldOps(spec, "cpu")
    vals = _ints(spec, 6, 40)[1:]  # nonzero
    a = f.from_ints(vals)
    assert f.to_ints(a) == vals
    assert f.to_ints(f.inv_(a)) == [pow(v, -1, spec.modulus) for v in vals]


def test_non_cpu_tensor_never_takes_the_plain_version():
    """Only CPU tensors run the plain version; any other device launches
    the kernel or raises (here: meta tensors, rejected before a launch)."""
    from tpu_ec_torch.errors import DeviceError

    a = torch.zeros((4, 16), dtype=torch.int32, device="meta")
    with pytest.raises(DeviceError):
        mont_mul(tfp.BLS12_381_FR, a, a)


@pytest.mark.parametrize("name", FIELDS)
def test_mont_plain_exact_at_extreme_limbs(name):
    """K1's plain version sums its columns in float64; at the largest
    columns it still equals Python ints of the same reduction.  The inputs
    include every half-limb 0xFFFF (R - 1, not canonical, the largest
    columns) and (p - 1)^2; the model is SOS with one conditional
    subtraction: m = (ab mod R) n' mod R, u = (ab + mp) / R, less p where
    u >= p."""
    spec = getattr(tfp, name)
    p, L = spec.modulus, spec.n_limbs
    R = 1 << (16 * L)
    nprime = -pow(p, -1, R) % R
    pairs = [(R - 1, R - 1), (p - 1, p - 1), (R - 1, p - 1), (p - 1, R - 1), (R - 1, 1), (p - 1, 1), (0, R - 1)]

    def limbs(xs):
        return limbs_to_torch(np.array([[(x >> (16 * i)) & 0xFFFF for i in range(L)] for x in xs]), "cpu")

    def model(a, b):
        u = (a * b + (a * b % R) * nprime % R * p) // R
        return u - p if u >= p else u

    got = limbs_to_numpy(mont_mul_plain(spec, limbs([a for a, _ in pairs]), limbs([b for _, b in pairs])))
    assert [sum(int(v) << (16 * i) for i, v in enumerate(row)) for row in got] == [model(a, b) for a, b in pairs]
    assert model(p - 1, p - 1) == (p - 1) ** 2 * pow(R, -1, p) % p


@pytest.mark.parametrize("name", ["BLS12_381_FQ", "BN254_FQ"])
def test_mul_chain_plain_matches_bigints(name):
    """The chains' product-latency yardstick (``kernels.point.mul_chain``,
    one thread of the card; its plain version here): a b^k R^-k mod p, as
    Python integers give it, for k = 0, 1, 5."""
    from tpu_ec_torch.kernels.point import mul_chain

    spec = getattr(tfp, name)
    p, R = spec.modulus, 1 << (16 * spec.n_limbs)
    a, b = _ints(spec, 7, 30)[5:7]
    limbs = lambda v: torch.tensor([(v >> (16 * i)) & 0xFFFF for i in range(spec.n_limbs)], dtype=torch.int64)
    for k in (0, 1, 5):
        want = a * pow(b, k, p) * pow(pow(R, k, p), -1, p) % p
        assert torch.equal(mul_chain(spec, limbs(a), limbs(b), k), limbs(want)), k
