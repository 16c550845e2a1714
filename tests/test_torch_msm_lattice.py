"""The port's bucket-lattice MSM (unsigned and signed digits, ``multiexp_1bit``)
against the bigint oracle, the native C++ Pippenger and tpu_ec's planning.

Inputs carry an identity base, a zero scalar and a duplicated point and
scalar (the edge inputs of tests/test_msm.py), and n = 7 pads the lattice
with identity rows.  The lattice runs its plain K3 on the CPU, a few
seconds a case (the bucket reduction and the Horner are hundreds of point
ops in series), so the cases cover each window, group count, size, curve
and sign once rather than every combination.  tpu_ec's own lattice takes
about a minute of XLA-CPU compile, so the one comparison of Jacobian
outputs with it is marked slow.  Tolerance: none (integers).
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax.numpy as jnp

from tpu_ec.curves import oracle
from tpu_ec.curves import params as jcp
from tpu_ec.ops import msm as jmsm
from tpu_ec_torch import curves
from tpu_ec_torch.native import native_curve
from tpu_ec_torch.ops import msm as tmsm
from tpu_ec_torch.ops.msm import MultiexpKernel, make_digits, multiexp_1bit


def _inputs(jspec, n, seed):
    pts = oracle.random_points(jspec, n, seed=seed)
    ks = oracle.random_scalars(jspec, n, seed=seed + 1)
    pts[0] = None  # identity base
    ks[1] = 0  # zero scalar: every digit 0
    pts[3], ks[3] = pts[2], ks[2]  # a duplicate: the same bucket twice, the doubling branch
    return pts, ks


def _check(curve, pts, ks, out, ops):
    got = ops.to_affine_ints(ops.to_affine(out))[0]
    jspec = getattr(jcp, curve.upper())
    assert got == oracle.msm(jspec, pts, ks)
    assert got == native_curve(ops.spec).msm_points(pts, ks)


def _counting(calls: dict, name: str, fn):
    def wrapped(*args, **kw):
        calls[name] += 1
        return fn(*args, **kw)

    return wrapped


@pytest.mark.parametrize(
    "curve,n,w,G,signed",
    [
        ("bn254_g1", 7, 8, 2, True),
        ("bls12_381_g1", 32, 4, 4, True),
        ("bls12_381_g2", 8, 3, 2, False),
    ],
)
def test_lattice_matches_oracle_and_native(monkeypatch, curve, n, w, G, signed):
    """One MSM each, its K3 calls counted (on the card each is one K3
    launch) against ``lattice_steps``."""
    calls = {"add_mixed": 0, "add": 0, "horner": 0}
    for name in ("add", "add_mixed"):
        monkeypatch.setattr(tmsm.PointOps, name, _counting(calls, name, getattr(tmsm.PointOps, name)))
    monkeypatch.setattr(tmsm, "horner", _counting(calls, "horner", tmsm.horner))
    spec = getattr(curves, curve.upper())
    pts, ks = _inputs(getattr(jcp, curve.upper()), n, seed=3 * n + w)
    kern = MultiexpKernel(spec, "cpu")
    ops = kern.ops
    out = kern.multiexp(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), window_size=w, num_groups=G,
                        signed=signed, method="lattice")
    assert calls == tmsm.lattice_steps(-(-n // G), G, w, signed)
    assert out[0].shape == (1, ops.width)
    _check(curve, pts, ks, out, ops)


def test_multiexp_1bit_matches_oracle_and_native():
    """Window 1, unsigned, the default groups (G = 1 at n = 8: 8 steps)."""
    spec = curves.BN254_G1
    pts, ks = _inputs(jcp.BN254_G1, 8, seed=90)
    ops = MultiexpKernel(spec, "cpu").ops
    out = multiexp_1bit(spec, ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), device="cpu")
    _check("bn254_g1", pts, ks, out, ops)


def test_default_window_and_groups_match_tpu_ec():
    for log_n in range(1, 25):
        n = 1 << log_n
        assert tmsm.default_window_size(n) == jmsm.default_window_size(n)
        for w in (1, 2, 3, 4, 8, tmsm.default_window_size(n)):
            assert tmsm.default_num_groups(n, w) == jmsm.default_num_groups(n, w)
    for n in (0, 1, 7, 1000, 3 << 20):
        assert tmsm.default_window_size(n) == jmsm.default_window_size(n)


@pytest.mark.parametrize("w", [1, 3, 4, 8, 12])
def test_make_digits_unsigned_matches_tpu_ec(w):
    rng = np.random.default_rng(40 + w)
    s = rng.integers(0, 1 << 16, (33, 17), dtype=np.int64)
    s[:, -1] = 0  # the zero limb the windows read past the top
    s[0, :16] = 0xFFFF
    s[1] = 0
    W = -(-tmsm.SCALAR_BITS // w)
    want = np.asarray(jmsm.make_digits(jnp.asarray(s, jnp.uint32), w, W, False))
    got = make_digits(torch.as_tensor(s), w, W, False)
    assert got.dtype == torch.int32 and np.array_equal(got.numpy(), want)


def test_prepare_inputs_matches_tpu_ec():
    """n = 7 on G = 4: padded to 8 with an identity point and a zero scalar,
    one zero limb added, reshaped to (m, G)."""
    jspec, spec = jcp.BN254_G1, curves.BN254_G1
    pts, ks = _inputs(jspec, 7, seed=50)
    ops = MultiexpKernel(spec, "cpu").ops
    jops = jmsm.point_ops(jspec)
    jpts, js, jm = jmsm.MultiexpKernel(jspec).prepare_inputs(jops.from_affine_ints(pts), jops.scalars_to_limbs(ks), 4)
    tpts, ts, tm = tmsm.prepare_inputs(ops.from_affine_ints(pts), ops.scalars_to_limbs(ks), 4)
    assert tm == jm == 2
    assert np.array_equal(ts.numpy(), np.asarray(js).astype(np.int64))
    for t, j in zip(tpts, jpts):
        assert t.shape == (2, 4, ops.width)
        assert np.array_equal(t.numpy().astype(np.int64), np.asarray(j).astype(np.int64))


def test_routing(monkeypatch):
    """"auto" with signed=False runs the lattice (one MSM, and each chunk of
    a batch); the pair, scan and co-Z engines refuse unsigned digits; the
    sorted engine is the one left unported."""
    seen = []

    def lattice(ops, points, scalars, **kw):
        seen.append(kw)
        return "lattice"

    monkeypatch.setattr(tmsm, "msm_lattice", lattice)
    kern = MultiexpKernel(curves.BN254_G1, "cpu")
    bases = tuple(torch.zeros((8, kern.ops.width), dtype=torch.int32) for _ in range(2))
    scal = torch.zeros((8, 16), dtype=torch.int32)
    assert kern.multiexp(bases, scal, signed=False) == "lattice"
    assert seen[-1] == {"window_size": tmsm.default_window_size(8), "signed": False}
    assert kern.multiexp(bases, scal, method="lattice", window_size=3) == "lattice"
    assert seen[-1] == {"window_size": 3, "signed": True}
    with pytest.raises(ValueError, match="power of two"):
        kern.multiexp(bases, scal, signed=False, num_groups=3)
    for method in ("pair", "scan", "coz"):
        with pytest.raises(ValueError, match="signed digits only"):
            kern.multiexp(bases, scal, signed=False, method=method)
    for method in ("pair", "scan"):
        with pytest.raises(ValueError, match="signed digits only"):
            kern.multiple_multiexp(bases, scal, 2, signed=False, method=method)
    with pytest.raises(NotImplementedError, match="item 9"):
        kern.multiexp(bases, scal, method="sorted")
    assert tmsm._NOT_PORTED == {"sorted": "item 9"}

    def one(self, b, s, **kw):
        seen.append(kw)
        return tuple(torch.zeros((1, self.ops.width), dtype=torch.int32) for _ in range(3))

    monkeypatch.setattr(MultiexpKernel, "multiexp", one)
    out = kern.multiple_multiexp(bases, scal, 2, signed=False, num_groups=2)
    assert out[0].shape == (2, kern.ops.width)
    assert seen[-1] == {"window_size": None, "num_groups": 2, "signed": False, "method": "lattice"}


@pytest.mark.slow
def test_lattice_jacobian_matches_tpu_ec():
    """The Jacobian output, bit for bit, of tpu_ec's _msm_lattice (BN254 G1,
    n = 8, w = 4, G = 2, unsigned; ~1 minute of XLA-CPU compile)."""
    jspec, spec = jcp.BN254_G1, curves.BN254_G1
    pts, ks = _inputs(jspec, 8, seed=70)
    jops = jmsm.point_ops(jspec)
    jk = jmsm.MultiexpKernel(jspec)
    jp, js, _ = jk.prepare_inputs(jops.from_affine_ints(pts), jops.scalars_to_limbs(ks), 2)
    want = jmsm._msm_lattice(jops, jp, js, window_size=4, signed=False)
    kern = MultiexpKernel(spec, "cpu")
    got = kern.multiexp(kern.ops.from_affine_ints(pts), kern.ops.scalars_to_limbs(ks), window_size=4, num_groups=2,
                        signed=False)
    for g, j in zip(got, want):
        assert np.array_equal(g.numpy().astype(np.int64), np.asarray(j).astype(np.int64))
