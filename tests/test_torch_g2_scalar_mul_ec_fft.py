"""The port's G2 scalar multiplication and G2 EC-group FFT.

- ``PointOps.scalar_mul`` on 2 BLS12-381 G2 points (the size of
  tests/test_curves.py's G2 case) against tpu_ec's ``scalar_mul`` (jnp, 256
  double-and-add steps), Jacobian coordinates bit for bit; scalars r - 1
  and a random one;
- ``EcFftKernel.radix_ec_fft`` on BN254 G2 at n = 8 against the native C++
  EC-FFT with ext = 2 (affine); the inverse gives its input back.  The n =
  4 transform against tpu_ec's is test_torch_g2_ec_fft_n4.py (tpu_ec's G2
  transform takes minutes of XLA-CPU compile: a file of its own runs beside
  this one).

tpu_ec runs G2 on its jnp formulas; the port runs K3's plain version of
its Fq2 chain and stage entries on the CPU.  Inputs from oracle seeds;
tolerance: none (integers).
"""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax
import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G2 as J_BLS, BN254_G2 as J_BN
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec_torch.convert import g2_points_to_numpy, g2_points_to_torch, limbs_to_torch
from tpu_ec_torch.curves import BLS12_381_G2, BN254_G2, PointOps
from tpu_ec_torch.native import native_curve
from tpu_ec_torch.ops.ec_fft import EcFftKernel


def _same(got, want):
    return all(np.array_equal(g[k], np.asarray(w[k])) for g, w in zip(g2_points_to_numpy(got), want) for k in range(2))


def test_scalar_mul_matches_tpu_ec():
    jops = j_point_ops(J_BLS)
    A = jops.from_affine_ints(oracle.random_points(J_BLS, 2, seed=100))
    P = jops.add_mixed(jops.double(jops.to_jacobian(A)), A)  # z != 1
    ks = [J_BLS.scalar.modulus - 1, random.Random(101).randrange(J_BLS.scalar.modulus)]
    k = jops.scalars_to_limbs(ks)
    want = jax.jit(jops.scalar_mul)(P, k)
    ops = PointOps(BLS12_381_G2, "cpu")
    Pt = g2_points_to_torch(tuple(tuple(map(np.asarray, c)) for c in P), "cpu")
    got = ops.scalar_mul(Pt, limbs_to_torch(np.asarray(k), "cpu"))
    assert _same(got, want)
    pts = ops.to_affine_ints(ops.to_affine(got))
    assert pts == [oracle.scalar_mul(J_BLS, p, 3 * s) for p, s in zip(oracle.random_points(J_BLS, 2, seed=100), ks)]


def test_ec_fft_n8_matches_native_and_inverts():
    nc = native_curve(BN254_G2)
    pts = oracle.random_points(J_BN, 8, seed=104)
    pts[3] = None
    kern = EcFftKernel(BN254_G2, "cpu")
    ops = kern.ops
    P = ops.to_jacobian(ops.from_affine_ints(pts))
    out = kern.radix_ec_fft(P)
    jac = np.concatenate([nc.coord_from_halflimbs(c.numpy()) for c in P], axis=1)
    want = nc.affine_to_points(nc.to_affine(nc.ec_fft(jac)))
    assert ops.to_affine_ints(ops.to_affine(out)) == want
    back = kern.radix_ec_fft(out, inverse=True)
    assert ops.to_affine_ints(ops.to_affine(back)) == pts
