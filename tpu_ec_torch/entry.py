"""The port's entry point: one commit of the flagship pipeline.

Twin of the repository's ``__graft_entry__.entry`` for ``tpu_ec_torch``: a
KZG-style commit on BN254 G1 at n = 64 (NTT the coefficients, convert out
of Montgomery form, MSM the evaluations against a table of valid points),
on the port's ``CommitPipeline.commit``, whose MSM is the pair engine.

    fn, args = entry()            # on the card
    evals, commitment = fn(*args)

The inputs are real: reduced Fr coefficients and points k*G with random
64-bit k (K3's chain entry), from seed 0.

``dryrun_multichip(n_devices)`` runs one step of the distributed path on
spawned ranks, the twin of ``__graft_entry__.dryrun_multichip``.
"""

from __future__ import annotations

import random


def entry(device="cuda"):
    """(fn, args): ``fn(*args)`` runs one BN254 commit at n = 64 and returns
    (evaluations (n, Ls) Montgomery, commitment: a Jacobian point with batch
    shape (1,))."""
    from .curves.params import BN254_G1
    from .ops.pipeline import CommitPipeline

    spec = BN254_G1
    n = 64
    pipe = CommitPipeline(spec, device)
    ops = pipe.ops
    rng = random.Random(0)
    coeffs = pipe.fr.from_ints([rng.randrange(spec.scalar.modulus) for _ in range(n)])
    g = ops.to_jacobian(ops.from_affine_ints([(spec.gen_x, spec.gen_y)]))
    ks = ops.scalars_to_limbs([rng.randrange(1, 1 << 64) for _ in range(n)])
    points = ops.to_affine(ops.scalar_mul(tuple(c.expand(n, -1) for c in g), ks))
    return pipe.commit, (coeffs, points)


def dryrun_multichip(n_devices: int, device="cuda") -> None:
    """One step of the distributed path on ``n_devices`` ranks (the twin of
    the repository's ``__graft_entry__.dryrun_multichip``): spawned ranks
    (``parallel.run_spmd``: NCCL, one card a rank, on "cuda"; gloo on
    "cpu") run the BLS12-381 Fr distributed NTT at 2^14, whose first rows
    must equal the bigint ``ntt_ref``, and the BN254 G1 distributed MSM at
    2^10, which must equal the native Pippenger.  Raises ``DeviceError``
    with fewer cards than ranks, and fails where a rank fails."""
    from .parallel.mesh import run_spmd

    run_spmd(_dryrun_rank, n_devices, device=device)


def _dryrun_rank() -> None:
    """The dry run's body on one rank; rank 0 makes the points and checks
    the results."""
    import numpy as np
    import torch
    import torch.distributed as dist

    from .curves.params import BN254_G1
    from .curves.point import PointOps
    from .fields.fp import FieldOps
    from .fields.params import BLS12_381_FR
    from .native import native_curve
    from .ops.ntt import ntt_ref
    from .parallel import DistFftKernel, DistMultiexpKernel, make_mesh, shard_leading

    mesh = make_mesh()
    # the distributed NTT at 2^14, its first rows against the bigint NTT
    f = FieldOps(BLS12_381_FR, mesh.device)
    rng = random.Random(7)
    vals = [rng.randrange(BLS12_381_FR.modulus) for _ in range(1 << 14)]
    y = DistFftKernel(BLS12_381_FR, mesh).radix_fft(shard_leading(f.from_ints(vals), mesh))
    if mesh.rank == 0 and f.to_ints(y[:4]) != ntt_ref(BLS12_381_FR, vals)[:4]:
        raise AssertionError("distributed NTT mismatch vs the bigint NTT")

    # the distributed MSM at 2^10: points k*G (random 64-bit k, the native
    # library's scalar multiplication on rank 0, broadcast), Fr scalars
    spec, n = BN254_G1, 1 << 10
    ops = PointOps(spec, mesh.device)
    rng = random.Random(8)
    ks = np.array([rng.randrange(1, 1 << 64) for _ in range(n)], dtype=np.uint64)
    scalars = [rng.randrange(spec.scalar.modulus) for _ in range(n)]
    points = torch.empty((2, n, ops.width), dtype=ops.fq.dtype, device=mesh.device)
    if mesh.rank == 0:
        nc = native_curve(spec)
        g = nc.affine_from_points([(spec.gen_x, spec.gen_y)])
        k4 = np.zeros((n, 4), dtype=np.uint64)
        k4[:, 0] = ks
        aff = nc.to_affine(nc.scalar_mul(np.broadcast_to(g, (n, g.shape[1])).copy(), k4))
        for i in range(2):
            coord = nc.coord_to_halflimbs(aff[:, i * nc.w : (i + 1) * nc.w]).astype(np.int64)
            points[i] = torch.as_tensor(coord).to(points.device, points.dtype)
    dist.broadcast(points, 0)
    points = (points[0], points[1])
    out = DistMultiexpKernel(spec, mesh).multiexp(shard_leading(points, mesh),
                                                  shard_leading(ops.scalars_to_limbs(scalars), mesh))
    if mesh.rank == 0:
        want = native_curve(spec).msm_points(ops.to_affine_ints(points), scalars)
        if ops.to_affine_ints(ops.to_affine(out))[0] != want:
            raise AssertionError("distributed MSM mismatch vs the native Pippenger")
