"""The port's commit pipeline (NTT -> from_mont -> pair MSM) against the references.

- n = 32, BLS12-381 G1: against ``tpu_ec.ops.pipeline.CommitPipeline.commit``
  (evaluations bit for bit, the commitment after ``to_affine``);
- n = 2^10, where the port takes the digit-NTT route: the evaluations against
  tpu_ec's ``FftKernel.radix_fft``, the commitment against the native C++
  Pippenger (``tpu_ec.native``).

Inputs come from seeds; tolerance: none (integers).
"""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_G1
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec.fields import field_ops as j_field_ops
from tpu_ec.native import native_curve
from tpu_ec.ops.ntt import FftKernel as JFftKernel
from tpu_ec.ops.pipeline import CommitPipeline as JCommitPipeline
from tpu_ec_torch.convert import limbs_to_numpy, limbs_to_torch, points_to_numpy, points_to_torch
from tpu_ec_torch.curves import BLS12_381_G1
from tpu_ec_torch.ops.pipeline import CommitPipeline


def _coeffs(n, seed):
    rng = random.Random(seed)
    return [rng.randrange(J_G1.scalar.modulus) for _ in range(n)]


def test_commit_n32_matches_tpu_ec():
    jops = j_point_ops(J_G1)
    jfr = j_field_ops(J_G1.scalar)
    coeffs = np.asarray(jfr.from_ints(_coeffs(32, 40)))
    bases = tuple(np.asarray(c) for c in jops.from_affine_ints(oracle.random_points(J_G1, 32, seed=41)))

    j_evals, j_commit = JCommitPipeline(J_G1).commit(coeffs, bases)
    want_affine = tuple(np.asarray(c) for c in jops.to_affine(j_commit))

    pipe = CommitPipeline(BLS12_381_G1, "cpu")
    evals, commit = pipe.commit(limbs_to_torch(coeffs, "cpu"), points_to_torch(bases, "cpu"))
    assert np.array_equal(limbs_to_numpy(evals), np.asarray(j_evals)), "NTT stage"
    got_affine = points_to_numpy(pipe.ops.to_affine(commit))
    assert all(np.array_equal(g, w) for g, w in zip(got_affine, want_affine)), "commitment"


def test_commit_n1024_digit_route_vs_native():
    n = 1 << 10
    nc = native_curve(J_G1)
    rng = np.random.default_rng(42)
    ks = np.zeros((n, 4), dtype=np.uint64)
    ks[:, 0] = rng.integers(1, 1 << 63, n, dtype=np.uint64)
    G = nc.affine_from_points([oracle.generator(J_G1)])
    aff = nc.to_affine(nc.scalar_mul(np.broadcast_to(G, (n, G.shape[1])).copy(), ks))
    w = nc.w
    bases = (nc.fq.to_halflimbs(aff[:, :w]), nc.fq.to_halflimbs(aff[:, w:]))
    jfr = j_field_ops(J_G1.scalar)
    coeffs = np.asarray(jfr.from_ints(_coeffs(n, 43)))

    pipe = CommitPipeline(BLS12_381_G1, "cpu")
    evals, commit = pipe.commit(limbs_to_torch(coeffs, "cpu"), points_to_torch(bases, "cpu"))
    want_evals = np.asarray(JFftKernel(J_G1.scalar).radix_fft(coeffs))
    assert np.array_equal(limbs_to_numpy(evals), want_evals), "NTT stage (digit route)"

    eval_ints = jfr.to_ints(want_evals)
    want = nc.affine_to_points(nc.to_affine(nc.msm(aff, nc.scalars_from_ints(eval_ints))[None, :]))[0]
    assert pipe.ops.to_affine_ints(pipe.ops.to_affine(commit))[0] == want, "commitment"


def test_entry_points_default_to_the_card():
    """Without ``device`` every entry point runs on the card; where there is
    none it raises instead of carrying on on the CPU."""
    from tpu_ec_torch.convert import limbs_to_torch
    from tpu_ec_torch.errors import DeviceError
    from tpu_ec_torch.fields import FieldOps
    from tpu_ec_torch.ops.ntt import FftKernel

    if torch.cuda.is_available():
        assert CommitPipeline(BLS12_381_G1).device.type == "cuda"
        return
    for make in (
        lambda: CommitPipeline(BLS12_381_G1),
        lambda: FftKernel(BLS12_381_G1.scalar),
        lambda: FieldOps(BLS12_381_G1.base),
        lambda: limbs_to_torch(np.zeros((1, 16), np.uint32)),
    ):
        with pytest.raises(DeviceError, match="device='cpu'"):
            make()
