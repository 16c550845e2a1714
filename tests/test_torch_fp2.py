"""The port's Fq2 (``tpu_ec_torch.fields.fp2.Fp2Ops``) and the FieldOps
methods it and G2 use, against tpu_ec's ``fp2_ops`` and ``field_ops``.

On both base fields (BLS12-381 Fq, BN254 Fq), the same inputs, made from a
numpy seed with the edge values 0, 1, p - 1, u and -u mixed in, go through
tpu_ec (jnp on the CPU; its Fq2 reaches no Pallas kernel) and the port on
the CPU (K1's plain version for the products).  Values are compared as
tpu_ec's (c0, c1) half-limb pairs; tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.fields.fp import field_ops as j_field_ops
from tpu_ec.fields.fp2 import fp2_ops as j_fp2_ops
from tpu_ec.fields import params as jfp
from tpu_ec_torch.convert import fp2_to_numpy, fp2_to_torch, limbs_to_numpy, limbs_to_torch
from tpu_ec_torch.fields import FieldOps, Fp2Ops
from tpu_ec_torch.fields import params as tfp

N = 12


def _elements(spec, seed):
    """N random Fq2 elements as int pairs; rows 0-5: 0, 1, p - 1, u, -u,
    (p - 1) + (p - 1) u."""
    p = spec.modulus
    rng = np.random.default_rng(seed)
    vals = [(int.from_bytes(rng.bytes(48), "little") % p, int.from_bytes(rng.bytes(48), "little") % p)
            for _ in range(N)]
    vals[:6] = [(0, 0), (1, 0), (p - 1, 0), (0, 1), (0, p - 1), (p - 1, p - 1)]
    return vals


@pytest.fixture(scope="module", params=["BLS12_381_FQ", "BN254_FQ"])
def fields(request):
    """(tpu_ec Fp2Ops, the port's, a, b as tpu_ec pairs, a, b as port tensors)."""
    jspec, tspec = getattr(jfp, request.param), getattr(tfp, request.param)
    jf, tf = j_fp2_ops(jspec), Fp2Ops(tspec, "cpu")
    a, b = jf.from_ints(_elements(jspec, 1)), jf.from_ints(_elements(jspec, 2)[::-1])
    a, b = tuple(map(np.asarray, a)), tuple(map(np.asarray, b))
    return jf, tf, a, b, fp2_to_torch(a, "cpu"), fp2_to_torch(b, "cpu")


def _same(got, want):
    g = fp2_to_numpy(got)
    return all(np.array_equal(x, np.asarray(y)) for x, y in zip(g, want))


@pytest.mark.parametrize("op", ["add", "sub", "mul"])
def test_binary_ops(fields, op):
    jf, tf, a, b, ta, tb = fields
    assert _same(getattr(tf, op)(ta, tb), getattr(jf, op)(a, b))
    assert _same(getattr(tf, op)(ta, ta), getattr(jf, op)(a, a))


@pytest.mark.parametrize("op", ["neg", "double", "sqr", "inv_"])
def test_unary_ops(fields, op):
    jf, tf, a, _, ta, _ = fields
    assert _same(getattr(tf, op)(ta), getattr(jf, op)(a))


def test_predicates_select_and_constants(fields):
    jf, tf, a, b, ta, tb = fields
    assert np.array_equal(tf.eq(ta, ta).numpy(), np.asarray(jf.eq(a, a)))
    assert np.array_equal(tf.eq(ta, tb).numpy(), np.asarray(jf.eq(a, b)))
    assert np.array_equal(tf.is_zero(ta).numpy(), np.asarray(jf.is_zero(a)))
    cond = torch.arange(N) % 3 == 0
    assert _same(tf.select(cond, ta, tb), jf.select(np.asarray(cond.numpy()), a, b))
    assert _same(tf.one[None], tuple(np.asarray(c)[None] for c in jf.one))
    assert _same(tf.zero[None], tuple(np.asarray(c)[None] for c in jf.zero))
    assert _same(tf.constant(7, 9)[None], tuple(np.asarray(c)[None] for c in jf.constant(7, 9)))


def test_mul_by_fp_and_batch_inverse(fields):
    jf, tf, a, _, ta, _ = fields
    k = jf.fp.from_ints([12345])[0]
    assert _same(tf.mul_by_fp(ta, limbs_to_torch(np.asarray(k), "cpu")), jf.mul_by_fp(a, k))
    # the product of each nonzero element with its batch inverse is one;
    # zeros stay zero (tpu_ec's _batch_inverse semantics)
    inv = tf.batch_inverse(ta)
    prod = tf.mul(ta, inv)
    iz = tf.is_zero(ta)
    assert bool(tf.is_zero(inv[iz]).all())
    assert bool(tf.eq(prod[~iz], tf.one.expand_as(prod[~iz])).all())
    assert _same(inv[~iz], jf.inv_(tuple(c[~iz.numpy()] for c in a)))


def test_int_roundtrip(fields):
    jf, tf, a, _, ta, _ = fields
    ints = jf.to_ints(a)
    assert tf.to_ints(ta) == ints
    assert torch.equal(tf.from_ints(ints), ta)
    assert tf.to_ints(ta, mont=False) == jf.to_ints(a, mont=False)


# -- the FieldOps methods added with Fq2 ------------------------------------


@pytest.fixture(scope="module", params=["BLS12_381_FQ", "BN254_FR"])
def base(request):
    jspec, tspec = getattr(jfp, request.param), getattr(tfp, request.param)
    jf, tf = j_field_ops(jspec), FieldOps(tspec, "cpu")
    p = jspec.modulus
    rng = np.random.default_rng(3)
    vals = [int.from_bytes(rng.bytes(48), "little") % p for _ in range(N)]
    vals[:4] = [0, 1, p - 1, 2]
    a = np.asarray(jf.from_ints(vals))
    return jf, tf, a, limbs_to_torch(a, "cpu")


def test_gte_and_batch_inverse(base):
    jf, tf, a, ta = base
    b, tb = a[::-1].copy(), ta.flip(0)
    assert np.array_equal(tf.gte(ta, tb).numpy(), np.asarray(jf.gte(a, b)))
    assert np.array_equal(tf.gte(ta, ta).numpy(), np.asarray(jf.gte(a, a)))
    assert np.array_equal(limbs_to_numpy(tf.batch_inverse(ta)), np.asarray(jf.batch_inverse(a)))


def test_get_bits_and_pack(base):
    jf, tf, a, ta = base
    for skip, width in ((0, 1), (3, 5), (100, 16), (200, 13)):
        assert np.array_equal(tf.get_bits(ta, skip, width).numpy(), np.asarray(jf.get_bits(a, skip, width))), skip
    packed = tf.pack(ta)
    assert np.array_equal(packed.numpy(), np.asarray(jf.pack(a)).astype(np.int64))
    assert torch.equal(tf.unpack(packed), ta)


def test_pow_table_and_lookup(base):
    jf, tf, a, ta = base
    x, tx = a[:3], ta[:3]
    e = jf.from_ints([0, 5, jf.spec.modulus - 2], mont=False)
    table = tf.pow_table(tx)
    assert np.array_equal(limbs_to_numpy(table), np.asarray(jf.pow_table(x)))
    got = tf.pow_lookup(table, limbs_to_torch(np.asarray(e), "cpu"))
    assert np.array_equal(limbs_to_numpy(got), np.asarray(jf.pow_lookup(jf.pow_table(x), e)))
