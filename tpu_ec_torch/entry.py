"""The port's entry point: one commit of the flagship pipeline.

Twin of the repository's ``__graft_entry__.entry`` for ``tpu_ec_torch``: a
KZG-style commit on BN254 G1 at n = 64 (NTT the coefficients, convert out
of Montgomery form, MSM the evaluations against a table of valid points),
on the port's ``CommitPipeline.commit``, whose MSM is the pair engine.

    fn, args = entry()            # on the card
    evals, commitment = fn(*args)

The inputs are real: reduced Fr coefficients and points k*G with random
64-bit k (K3's chain entry), from seed 0.
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
