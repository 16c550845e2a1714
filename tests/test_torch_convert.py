"""convert.py round trips, the measurement helpers, and the port's
independence from JAX.

``tpu_ec_torch`` must import, and run its CPU pipeline, without jax or
tpu_ec: the machine with the card has no jax.  That is checked in a fresh
interpreter.
"""

import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec_torch.convert import (
    fp2_to_numpy,
    fp2_to_torch,
    g2_points_to_numpy,
    g2_points_to_torch,
    ints_to_limbs,
    limbs_to_ints,
    limbs_to_numpy,
    limbs_to_torch,
    points_to_numpy,
    points_to_torch,
)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_limbs_roundtrip():
    rng = np.random.default_rng(1)
    a = rng.integers(0, 1 << 16, (9, 24), dtype=np.int64).astype(np.uint32)
    t = limbs_to_torch(a, "cpu")
    assert t.dtype == torch.int64 and t.shape == (9, 24)
    back = limbs_to_numpy(t)
    assert back.dtype == np.uint32 and np.array_equal(back, a)
    pts = points_to_numpy(points_to_torch((a, a[::-1].copy()), "cpu"))
    assert np.array_equal(pts[0], a) and np.array_equal(pts[1], a[::-1])


def test_fp2_roundtrip():
    """tpu_ec's (c0, c1) Fq2 pairs <-> the port's (n, 2L) tensors, c0 first."""
    rng = np.random.default_rng(2)
    c0, c1 = (rng.integers(0, 1 << 16, (5, 24), dtype=np.int64).astype(np.uint32) for _ in range(2))
    t = fp2_to_torch((c0, c1), "cpu")
    assert t.shape == (5, 48) and np.array_equal(limbs_to_numpy(t[:, :24]), c0)
    back = fp2_to_numpy(t)
    assert back[0].dtype == np.uint32 and np.array_equal(back[0], c0) and np.array_equal(back[1], c1)
    pts = g2_points_to_numpy(g2_points_to_torch(((c0, c1), (c1, c0)), "cpu"))
    assert np.array_equal(pts[1][0], c1) and np.array_equal(pts[1][1], c0)


def test_ints_roundtrip_and_range_check():
    vals = [0, 1, (1 << 256) - 1, 12345678901234567890]
    assert limbs_to_ints(ints_to_limbs(vals, 16, "cpu")) == vals
    with pytest.raises(ValueError):
        limbs_to_torch(np.full((1, 16), 1 << 16, np.int64), "cpu")


def test_port_runs_without_jax():
    code = """
import sys
import torch
torch.set_num_threads(1)
from tpu_ec_torch.curves import BLS12_381_G1, PointOps
from tpu_ec_torch.fields import FieldOps
from tpu_ec_torch.ops.ntt import FftKernel
from tpu_ec_torch.ops.pipeline import CommitPipeline

ops = PointOps(BLS12_381_G1, "cpu")
fr = FieldOps(BLS12_381_G1.scalar, "cpu")
g = ops.from_affine_ints([(BLS12_381_G1.gen_x, BLS12_381_G1.gen_y)])
pts = [ops.to_jacobian(g)]
for _ in range(7):
    pts.append(ops.add_mixed(pts[-1], g))
bases = ops.to_affine(tuple(__import__("torch").cat(c) for c in zip(*pts)))
coeffs = fr.from_ints(list(range(3, 11)))
evals, commit = CommitPipeline(BLS12_381_G1, "cpu").commit(coeffs, bases)
assert evals.shape == (8, 16) and commit[0].shape == (1, 24)
assert ops.to_affine_ints(ops.to_affine(commit))[0] is not None
assert bool(fr.eq(evals, evals).all()) and not bool(fr.eq(coeffs, evals).all())
FftKernel(BLS12_381_G1.scalar, "cpu").radix_fft(fr.from_ints(list(range(1 << 10))))
# G2: Fq2, the point ops, one scan MSM
from tpu_ec_torch.curves import BLS12_381_G2
from tpu_ec_torch.fields import Fp2Ops
from tpu_ec_torch.ops.msm import MultiexpKernel
g2 = PointOps(BLS12_381_G2, "cpu")
G = g2.from_affine_ints([(BLS12_381_G2.gen_x, BLS12_381_G2.gen_y)])
D = g2.add_mixed(g2.double(g2.to_jacobian(G)), G)
m = MultiexpKernel(BLS12_381_G2, "cpu").multiexp(G, g2.scalars_to_limbs([3]), window_size=2)
assert bool(g2.eq(D, m).all()) and D[0].shape == (1, 48)
f2 = Fp2Ops(BLS12_381_G2.base, "cpu")
a = f2.from_ints([(3, 5)])
assert bool(f2.eq(f2.mul(a, f2.inv_(a)), f2.one[None]).all())
# every module of the package imports without jax
import pkgutil, importlib, tpu_ec_torch
for mod in pkgutil.walk_packages(tpu_ec_torch.__path__, "tpu_ec_torch."):
    importlib.import_module(mod.name)
bad = sorted(m for m in sys.modules if m == "jax" or m.startswith(("jax.", "tpu_ec.")) or m == "tpu_ec")
assert not bad, bad
print("ok")
"""
    env = dict(os.environ, PYTHONPATH=REPO)
    res = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip().endswith("ok")
