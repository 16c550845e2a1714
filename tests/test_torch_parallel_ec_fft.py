"""The port's distributed batched EC-FFT on gloo ranks, against tpu_ec.

One spawn of ranks a world size (d = 2 and d = 4, ``tests/
torch_dist_ranks.py``) transforms a stacked BN254 G1 batch of B = 8
transforms of n = 16 points, each rank its slab (``shard_leading``), both
directions, gathered on rank 0.  The forward batch of both world sizes is
held bit for bit against tpu_ec's ``DistEcFftKernel`` on a virtual mesh of
four devices (~45 s of XLA-CPU compile a mesh; each transform of the batch
runs the same integer program whatever the mesh size, so one mesh's output
serves both); the inverse, on four ranks, must give the input back.  The ranks run while
tpu_ec compiles.  Inputs come from seeds; tolerance: none (integers).
"""

import os

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_ranks as ranks
from tpu_ec.curves import oracle
from tpu_ec.curves.params import BN254_G1 as J_BN
from tpu_ec.parallel import DistEcFftKernel as JDistEcFft
from tpu_ec.parallel import make_mesh as j_make_mesh
from tpu_ec_torch.curves import BN254_G1, PointOps

B, N = 8, 16


def _batch():
    """(X, Y, Z) of (B, n, L) Jacobian points, B transforms of n points."""
    ops = PointOps(BN254_G1, "cpu")
    rows = [ops.to_jacobian(ops.from_affine_ints(oracle.random_points(J_BN, N, seed=70 + b))) for b in range(B)]
    return tuple(torch.stack(c) for c in zip(*rows))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """{d: (the directory of d's spawn, tpu_ec's forward batch on four
    devices)}; tpu_ec's reference is computed while the ranks run."""
    P = _batch()
    runs, work = [], {}
    for d in (2, 4):
        work[d] = str(tmp_path_factory.mktemp(f"ec_d{d}"))
        for name, c in zip("XYZ", P):
            np.save(os.path.join(work[d], f"ec_{name}.npy"), c.numpy())
        runs.append((d, (work[d], [], [], "both" if d == 4 else True, [])))
    spawn = ranks.Spawn(runs)
    jP = tuple(jnp.asarray(c.numpy().astype(np.uint32)) for c in P)
    want = JDistEcFft(J_BN, j_make_mesh(jax.devices()[:4])).radix_ec_fft_many(jP)
    want = [np.asarray(jax.device_get(w)).astype(np.int64) for w in want]
    spawn.join()
    return {d: (work[d], want) for d in (2, 4)}


@pytest.mark.parametrize("d", [2, 4])
def test_dist_ec_fft_matches_tpu_ec(runs, d):
    """Each rank's transforms, gathered, equal tpu_ec's DistEcFftKernel."""
    work, want = runs[d]
    got = np.load(os.path.join(work, "ec_out_0.npy"))
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def test_dist_ec_fft_inverse_round_trip(runs):
    """The inverse on four ranks of the forward output gives the input back
    (compared in affine: the inverse's scaling has its own Jacobian z)."""
    ops = PointOps(BN254_G1, "cpu")
    got = np.load(os.path.join(runs[4][0], "ec_out_1.npy"))
    back = ops.to_affine(tuple(torch.as_tensor(c).reshape(B * N, -1) for c in got))
    want = ops.to_affine(tuple(c.reshape(B * N, -1) for c in _batch()))
    assert all(torch.equal(a, b) for a, b in zip(back, want))
