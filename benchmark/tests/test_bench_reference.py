"""The plain reference on small known cases."""

import random

import pytest
import torch

from benchmark.program import dot_mod
from benchmark.reference.ec import FixedBase, Group
from benchmark.reference.limbs import LimbField, ints_to_limbs, limbs_to_ints
from benchmark.reference.params import CURVES

# y^2 = x^3 + b of each group (b of G2 as an Fq2 pair)
B = {"bls12_381_g1": 4, "bn254_g1": 3, "bls12_381_g2": (4, 4)}


def on_curve(g, A, b):
    F = g.F
    x, y = A
    rhs = F.add(F.mul(F.mul(x, x), x), b if isinstance(b, tuple) or g.curve.ext == 1 else (b, 0))
    return F.sub(F.mul(y, y), rhs) == F.zero


@pytest.mark.parametrize("name", sorted(CURVES))
def test_generator_order_and_small_multiples(name):
    c = CURVES[name]
    g = Group(c)
    assert g.is_identity(g.scalar_mul(c.gen, c.r))
    mult = g.multiples(c.gen, 6)
    assert mult[0] is None and mult[1] == c.gen
    for d in range(2, 6):
        assert mult[d] == g.to_affine_many([g.scalar_mul(c.gen, d)])[0]
    assert mult[2] == g.to_affine_many([g.double((*c.gen, g.F.one))])[0]
    if name in B:
        assert all(on_curve(g, A, B[name]) for A in mult[1:])


@pytest.mark.parametrize("name", ["bls12_381_g1", "bn254_g2"])
def test_fixed_base_is_scalar_mul(name):
    c = CURVES[name]
    g = Group(c)
    fb = FixedBase(g, c.gen)
    rng = random.Random(5)
    ks = [0, 1, 255, 256, c.r - 1, c.r] + [rng.randrange(c.r) for _ in range(4)]
    want = g.to_affine_many([g.scalar_mul(c.gen, k) for k in ks])
    assert fb.mul_many(ks) == want
    assert want[0] is None and want[5] is None


@pytest.mark.parametrize("name", ["bls12_381_g1", "bn254_g1"])
def test_limb_field_against_ints(name):
    c = CURVES[name]
    rng = random.Random(1)
    for p, L in ((c.r, c.r_limbs), (c.q, c.q_limbs)):
        F = LimbField(p, L)
        a = [0, 1, p - 1, p - 1] + [rng.randrange(p) for _ in range(60)]
        b = [p - 1, 0, 1, p - 1] + [rng.randrange(p) for _ in range(60)]
        ta, tb = F.tensor(a), F.tensor(b)
        assert limbs_to_ints(F.add(ta, tb)) == [(x + y) % p for x, y in zip(a, b)]
        assert limbs_to_ints(F.sub(ta, tb)) == [(x - y) % p for x, y in zip(a, b)]
        assert limbs_to_ints(F.mul(ta, tb)) == [x * y % p for x, y in zip(a, b)]
        rinv = pow(F.R, -1, p)
        assert limbs_to_ints(F.from_mont(ta)) == [x * rinv % p for x in a]


@pytest.mark.parametrize("log_n", [0, 1, 3, 5])
def test_ntt_matches_the_sum_and_inverts(log_n):
    c = CURVES["bls12_381_g1"]
    r, n = c.r, 1 << log_n
    F = LimbField(r, c.r_limbs)
    rng = random.Random(log_n)
    xs = [rng.randrange(r) for _ in range(n)]
    w = c.root_of_unity(log_n)
    X = F.ntt(torch.as_tensor(ints_to_limbs(xs, c.r_limbs)), w)
    assert limbs_to_ints(X) == [sum(x * pow(w, j * k, r) for j, x in enumerate(xs)) % r for k in range(n)]
    back = limbs_to_ints(F.ntt(X, pow(w, -1, r)))
    assert [v * pow(n, -1, r) % r for v in back] == xs
    assert pow(w, n, r) == 1 and (n == 1 or pow(w, n // 2, r) != 1)


def test_ntt_batches_along_the_leading_axes():
    c = CURVES["bn254_g1"]
    F = LimbField(c.r, c.r_limbs)
    x = torch.as_tensor(ints_to_limbs(range(1, 33), c.r_limbs)).reshape(2, 2, 8, c.r_limbs)
    w = c.root_of_unity(3)
    got = F.ntt(x, w)
    for i in range(2):
        for j in range(2):
            assert torch.equal(got[i, j], F.ntt(x[i, j], w))


def test_ec_fft_2p4_is_the_scalar_transform_on_logs():
    """A 2^4 EC-FFT computed point by point (sum_i w^(ij) P_i) equals
    NTT(a)_j G for P_i = a_i G: the identity the EC-FFT check rests on."""
    c = CURVES["bn254_g1"]
    g = Group(c)
    n, r = 16, c.r
    w = c.root_of_unity(4)
    rng = random.Random(7)
    a = [rng.randrange(1, 1 << 20) for _ in range(n)]
    P = g.to_affine_many([g.scalar_mul(c.gen, x) for x in a])
    F = LimbField(r, c.r_limbs)
    e = limbs_to_ints(F.ntt(torch.as_tensor(ints_to_limbs(a, c.r_limbs)), w))
    for j in range(n):
        acc = g.identity
        for i in range(n):
            acc = g.add_affine(acc, g.to_affine_many([g.scalar_mul(P[i], pow(w, i * j, r))])[0])
        assert g.matches(acc, g.to_affine_many([g.scalar_mul(c.gen, e[j])])[0])


def test_dot_mod_against_ints():
    rng = random.Random(3)
    r = CURVES["bls12_381_g1"].r
    s = [[rng.randrange(r) for _ in range(37)] for _ in range(3)]
    k = [[rng.randrange(1 << 80) for _ in range(37)] for _ in range(3)]
    st = torch.as_tensor([ints_to_limbs(row, 16) for row in s])
    kt = torch.as_tensor([ints_to_limbs(row, 5) for row in k])
    want = [sum(x * y for x, y in zip(a, b)) % r for a, b in zip(s, k)]
    assert dot_mod(st, kt, r, block=8) == want
    assert dot_mod(st[0], kt[0], r) == want[:1]
