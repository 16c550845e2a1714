"""The port's batch-affine and co-Z pair adds (kernels K6, K7) against tpu_ec, bit-exact.

The same numpy inputs go through ``tpu_ec.ops.pallas.affine`` in interpret
mode (as tests/test_pallas_affine.py runs it) and through the port on the
CPU, where every kernel wrapper runs its plain version.  Each batch mixes in
the degenerate rows the select trees choose around: P = identity,
Q = identity, both, P == Q, P == -Q, and y1 = 0 (the order-2 tangent; such
rows are not on the curve, the formulas are exercised all the same).
Outputs must be equal bit for bit, not merely the same points.  Tolerance:
none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax.numpy as jnp
import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_BLS, BN254_G1 as J_BN
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec.fields import field_ops as j_field_ops
from tpu_ec.ops.pallas import affine as jaff
from tpu_ec.ops.pallas.mont import from_planes, to_planes
from tpu_ec_torch.convert import limbs_to_numpy, limbs_to_torch
from tpu_ec_torch.curves import BLS12_381_G1, BN254_G1
from tpu_ec_torch.kernels import affine as kaff
from tpu_ec_torch.ops import affine as taff

CURVES = [(J_BLS, BLS12_381_G1), (J_BN, BN254_G1)]
IDS = ["bls12_381", "bn254"]


def _pairs(jspec, n, seed):
    """(x1, y1, x2, y2) numpy (n, L) Montgomery coordinates with the
    degenerate rows 0-5 described above."""
    pa = oracle.random_points(jspec, n, seed=seed)
    pb = oracle.random_points(jspec, n, seed=seed + 1)
    pa[0] = None  # P = identity
    pb[1] = None  # Q = identity
    pa[2] = pb[2] = None  # both
    pb[3] = pa[3]  # P == Q
    pb[4] = oracle.neg(jspec, pa[4])  # P == -Q
    ops = j_point_ops(jspec)
    x1, y1 = (np.array(c) for c in ops.from_affine_ints(pa))
    x2, y2 = (np.array(c) for c in ops.from_affine_ints(pb))
    y1[5] = 0  # order-2 tangent: (x, 0) + (x, 0)
    x2[5], y2[5] = x1[5], 0
    return x1, y1, x2, y2


def _t(*arrs):
    return tuple(limbs_to_torch(a, "cpu") for a in arrs)


def _same(got, want):
    return all(np.array_equal(limbs_to_numpy(g), np.asarray(w)) for g, w in zip(got, want))


@pytest.mark.parametrize("jspec,tspec", CURVES, ids=IDS)
def test_affine_add_batch(jspec, tspec):
    x1, y1, x2, y2 = _pairs(jspec, 24, 30)
    want = jaff.affine_add_batch(jspec.base, (x1, y1), (x2, y2), interpret=True)
    X1, Y1, X2, Y2 = _t(x1, y1, x2, y2)
    assert _same(taff.affine_add_batch(tspec.base, (X1, Y1), (X2, Y2)), want)


@pytest.mark.parametrize("jspec,tspec", CURVES, ids=IDS)
def test_coz_add_batch(jspec, tspec):
    x1, y1, x2, y2 = _pairs(jspec, 24, 32)
    (wx, wy), wr = jaff.coz_add_batch(jspec.base, (x1, y1), (x2, y2), interpret=True)
    X1, Y1, X2, Y2 = _t(x1, y1, x2, y2)
    (gx, gy), gr = taff.coz_add_batch(tspec.base, (X1, Y1), (X2, Y2))
    assert _same((gx, gy, gr), (wx, wy, wr))


@pytest.mark.parametrize("jspec,tspec", CURVES, ids=IDS)
def test_kernel_plain_versions(jspec, tspec):
    """K7 denom, K7 apply and K6 plain versions against the Pallas kernels
    one by one (tpu_ec's plane layout is the transpose of the port's rows)."""
    x1, y1, x2, y2 = _pairs(jspec, 20, 34)
    planes = [jnp.asarray(to_planes(jnp.asarray(c))) for c in (x1, y1, x2, y2)]
    rows = _t(x1, y1, x2, y2)
    spec, base = jspec.base, tspec.base

    d = jaff.affine_denom(spec, *planes, interpret=True)
    assert np.array_equal(limbs_to_numpy(kaff.affine_denom_plain(base, *rows)), np.asarray(from_planes(d)))

    iv = jaff.batch_inverse_planes(spec, d, interpret=True)
    want = jaff.affine_apply(spec, *planes, iv, interpret=True)
    got = kaff.affine_apply_plain(base, *rows, limbs_to_torch(np.asarray(from_planes(iv)), "cpu"))
    assert _same(got, [from_planes(c) for c in want])

    f = j_field_ops(spec)
    r1 = f.from_ints([12345])  # any scale: (1, L)
    r2, r3 = f.sqr(r1), f.mul(f.sqr(r1), r1)
    pp, _ = jaff.partial_products_planes(spec, d, interpret=True)
    want = jaff.coz_apply(spec, *planes, pp, to_planes(r2), to_planes(r3), interpret=True)
    got = kaff.coz_apply_plain(base, *rows, *_t(np.asarray(from_planes(pp)), np.asarray(r2), np.asarray(r3)))
    assert _same(got, [from_planes(c) for c in want])


def _field_rows(spec, n, seed):
    rng = np.random.default_rng(seed)
    vals = [int(rng.integers(1, 1 << 62)) * int(rng.integers(1, 1 << 62)) % spec.modulus or 1
            for _ in range(n)]
    return np.asarray(j_field_ops(spec).from_ints(vals))


@pytest.mark.parametrize("n", [1, 5, 33])
def test_batch_inverse_and_partial_products(n):
    spec, tspec = J_BLS.base, BLS12_381_G1.base
    a = _field_rows(spec, n, 40 + n)
    want_inv = from_planes(jaff.batch_inverse_planes(spec, to_planes(jnp.asarray(a)), interpret=True))
    want_pp, want_root = jaff.partial_products_planes(spec, to_planes(jnp.asarray(a)), interpret=True)
    (ta,) = _t(a)
    assert _same((taff.batch_inverse(tspec, ta),), (want_inv,))
    pp, root = taff.partial_products(tspec, ta)
    assert _same((pp, root), (from_planes(want_pp), from_planes(want_root)))


def test_coz_add_batch_windows_keep_their_own_roots():
    """A (W, s, L) batch is W independent problems: each window's outputs
    and root equal a separate 2-D call on that window alone."""
    tspec = BN254_G1.base
    wins = [_pairs(J_BN, 12, 50 + 2 * k) for k in range(3)]
    stacked = [torch.stack([_t(w[c])[0] for w in wins]) for c in range(4)]
    (gx, gy), gr = taff.coz_add_batch(tspec, tuple(stacked[:2]), tuple(stacked[2:]))
    assert gr.shape == (3, 1, tspec.n_limbs)
    for k, w in enumerate(wins):
        X1, Y1, X2, Y2 = _t(*w)
        (ex, ey), er = taff.coz_add_batch(tspec, (X1, Y1), (X2, Y2))
        assert torch.equal(gx[k], ex) and torch.equal(gy[k], ey) and torch.equal(gr[k], er)


@pytest.mark.parametrize("kernel", ["affine_denom", "affine_apply", "coz_apply", "ntt_leaf", "pease_stage"])
def test_non_cpu_tensor_never_takes_the_plain_version(kernel):
    """Only CPU tensors run a plain version; any other device launches the
    kernel or raises (here: meta tensors, rejected before a launch)."""
    from tpu_ec_torch.errors import DeviceError
    from tpu_ec_torch.kernels.butterfly import pease_stage
    from tpu_ec_torch.kernels.ntt_leaf import ntt_leaf

    c = torch.zeros((4, 24), dtype=torch.int32, device="meta")
    r = torch.zeros((16, 16), dtype=torch.int32, device="meta")
    call = {
        "affine_denom": lambda: kaff.affine_denom(BLS12_381_G1.base, c, c, c, c),
        "affine_apply": lambda: kaff.affine_apply(BLS12_381_G1.base, c, c, c, c, c),
        "coz_apply": lambda: kaff.coz_apply(BLS12_381_G1.base, c, c, c, c, c, c[:1], c[:1]),
        "ntt_leaf": lambda: ntt_leaf(BN254_G1.scalar, r.reshape(4, 4, 16), r),
        "pease_stage": lambda: pease_stage(BN254_G1.scalar, r, r[:8], 0),
    }[kernel]
    with pytest.raises(DeviceError):
        call()
