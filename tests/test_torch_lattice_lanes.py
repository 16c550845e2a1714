"""The bucket lattice's per-lane work (``kernels.point.lattice_lanes_plain``,
the plain version of K3's lattice entry) against the bigint oracle, lane by
lane: each bucket's affine value and each lane's sum_k k bucket_k.

The oracle recodes each scalar's window digits itself and adds the points
with tpu_ec's pure-Python affine arithmetic, so it shares nothing with the
port's digits or formulas.  Each lattice carries an identity base with a
nonzero scalar, a zero scalar, and one point with its scalar on two
consecutive steps of one group: its lanes name the same slot twice in a
row, and where the slot was empty the second add is the P == Q doubling.
Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from tpu_ec.curves import oracle
from tpu_ec.curves import params as jcp
from tpu_ec_torch import curves
from tpu_ec_torch.kernels.point import lattice_buckets_plain, lattice_lanes_plain
from tpu_ec_torch.ops.msm import SCALAR_BITS, MultiexpKernel, make_digits, prepare_inputs


def _digits(k: int, w: int, W: int, signed: bool) -> list[int]:
    """Base-2^w window digits of k, the signed ones by the carry recode
    (each in [-2^(w-1), 2^(w-1)])."""
    raws = [(k >> (w * j)) & ((1 << w) - 1) for j in range(W)]
    if not signed:
        return raws
    out, c, half = [], 0, 1 << (w - 1)
    for r in raws:
        t = r + c
        c = int(t > half)
        out.append(t - (c << w))
    return out


def _oracle_lanes(jspec, pts, ks, G, w, W, nbuckets, signed):
    """{(g, j): (buckets {slot: point}, sum_k k bucket_k)} by plain affine
    additions in step order; rows past n are padding (scalar 0)."""
    n = len(pts)
    m = -(-n // G)
    digits = [_digits(k, w, W, signed) for k in ks]
    lanes = {}
    for g in range(G):
        for j in range(W):
            b = {k: None for k in range(1, nbuckets)}
            for t in range(m):
                i = t * G + g
                d = digits[i][j] if i < n else 0
                if d:
                    p = pts[i] if d > 0 else oracle.neg(jspec, pts[i])
                    b[abs(d)] = oracle.add(jspec, b[abs(d)], p)
            running = acc = None
            for k in range(nbuckets - 1, 0, -1):
                running = oracle.add(jspec, running, b[k])
                acc = oracle.add(jspec, acc, running)
            lanes[g, j] = (b, acc)
    return lanes


@pytest.mark.parametrize(
    "curve,n,w,G,signed",
    [
        ("bn254_g1", 7, 3, 2, False),
        ("bn254_g1", 7, 3, 2, True),
        ("bls12_381_g1", 5, 4, 1, False),
        ("bls12_381_g1", 6, 2, 2, True),
        ("bls12_381_g2", 4, 4, 1, True),
    ],
)
def test_lattice_lanes_plain_matches_oracle(curve, n, w, G, signed):
    jspec = getattr(jcp, curve.upper())
    spec = getattr(curves, curve.upper())
    pts = oracle.random_points(jspec, n, seed=7 * n + w)
    ks = oracle.random_scalars(jspec, n, seed=7 * n + w + 1)
    pts[0] = None  # an identity base with a nonzero scalar
    ks[1] = 0  # a zero scalar: every digit 0
    pts[2 + G], ks[2 + G] = pts[2], ks[2]  # steps 0 and 1 of group 2 mod G: the same slots in a row
    assert ks[0] != 0
    W = -(-SCALAR_BITS // w)
    nbuckets = (1 << (w - 1) if signed else (1 << w) - 1) + 1
    ops = MultiexpKernel(spec, "cpu").ops
    (x, y), s, m = prepare_inputs(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), G)
    digits = make_digits(s.reshape(m * G, -1), w, W, signed).reshape(m, G * W)
    want = _oracle_lanes(jspec, pts, ks, G, w, W, nbuckets, signed)
    L = ops.width

    buckets = lattice_buckets_plain(spec.base, x, y, digits, nbuckets, signed, spec.ext)
    assert buckets.shape == (nbuckets, G, W, 3 * L)
    assert not buckets[0].any()  # nothing is added into slot 0
    flat = buckets[1:].reshape(-1, 3 * L)
    got = ops.to_affine_ints(ops.to_affine(tuple(flat[:, c * L : (c + 1) * L] for c in range(3))))
    for idx, p in enumerate(got):
        k, lane = divmod(idx, G * W)
        assert p == want[divmod(lane, W)][0][k + 1], (k + 1, divmod(lane, W))

    sums = lattice_lanes_plain(spec.base, x, y, digits, nbuckets, signed, spec.ext)
    assert all(c.shape == (G, W, L) for c in sums)
    got = ops.to_affine_ints(ops.to_affine(tuple(c.reshape(G * W, L) for c in sums)))
    assert got == [want[divmod(lane, W)][1] for lane in range(G * W)]


def test_lattice_lanes_on_the_cpu_is_the_plain_version_and_checks_its_operands():
    """On CPU tensors the entry's wrapper returns the plain version's sums;
    operands of the wrong shape raise before any work."""
    from tpu_ec_torch.kernels.point import lattice_lanes

    jspec, spec = jcp.BN254_G1, curves.BN254_G1
    pts = oracle.random_points(jspec, 2, seed=3)
    ks = oracle.random_scalars(jspec, 2, seed=4)
    ops = MultiexpKernel(spec, "cpu").ops
    (x, y), s, m = prepare_inputs(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), 1)
    W = -(-SCALAR_BITS // 2)
    digits = make_digits(s.reshape(m, -1), 2, W, False).reshape(m, W)
    got = lattice_lanes(spec.base, x, y, digits, 4, False)
    want = lattice_lanes_plain(spec.base, x, y, digits, 4, False)
    assert all(torch.equal(g, w) for g, w in zip(got, want))
    with pytest.raises(ValueError, match="digits"):
        lattice_lanes(spec.base, x, y, digits[:1], 4, False)
    with pytest.raises(ValueError, match="nbuckets"):
        lattice_lanes(spec.base, x, y, digits, 1, False)
    with pytest.raises(ValueError, match="x, y"):
        lattice_lanes(spec.base, x, y[:1], digits, 4, False)
