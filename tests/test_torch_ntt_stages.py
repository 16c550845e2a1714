"""K5's multi-stage entry and K4's level epilogue against tpu_ec, bit-exact.

``pease_stages_plain`` over every stage with the bit reversal against
tpu_ec's staged Pallas NTT in interpret mode (as tests/test_pallas_ntt.py
runs it), stage ranges against the composition of single stages, and
``ntt_leaf_plain(..., level=...)`` against tpu_ec's ``_leaf_apply``,
``_twiddle_mul`` and transpose at one level of the fused NTT.  Inputs come
from numpy seeds; tolerance: none (integers).
"""

import random

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax.numpy as jnp
import numpy as np

from tpu_ec.fields import field_ops as j_field_ops
from tpu_ec.fields import params as jfp
from tpu_ec_torch.convert import limbs_to_numpy, limbs_to_torch
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.kernels.butterfly import (
    pease_stage,
    pease_stage_plain,
    pease_stages,
    pease_stages_plain,
)
from tpu_ec_torch.kernels.mont import mont_mul_plain
from tpu_ec_torch.kernels.ntt_leaf import ntt_leaf, ntt_leaf_plain
from tpu_ec_torch.ops.ntt import FftKernel, get_domain

SPEC = tfp.BLS12_381_FR


def _mont_inputs(n, seed):
    spec = jfp.BLS12_381_FR
    rng = random.Random(seed)
    vals = [rng.randrange(spec.modulus) for _ in range(n)]
    vals[: min(3, n)] = [0, 1, spec.modulus - 1][: min(3, n)]
    return np.asarray(j_field_ops(spec).from_ints(vals))  # (n, 16) Montgomery


def _table(log_n, inverse=False):
    return limbs_to_torch(get_domain(SPEC, log_n, inverse).twiddles, "cpu")


@pytest.mark.parametrize("inverse", [False, True])
@pytest.mark.parametrize("log_n", [1, 3, 6, 9])
def test_pease_stages_plain_matches_pallas_interpret(log_n, inverse):
    """Every stage and the bit reversal (the inverse then scaled by n^-1)
    == tpu_ec's PallasFftKernel.radix_fft in interpret mode."""
    from tpu_ec.ops.pallas.ntt import PallasFftKernel

    x = _mont_inputs(1 << log_n, 600 + log_n)
    want = np.asarray(PallasFftKernel(jfp.BLS12_381_FR, block=128, interpret=True).radix_fft(
        jnp.asarray(x), inverse=inverse))
    y = pease_stages_plain(SPEC, limbs_to_torch(x, "cpu"), _table(log_n, inverse), 0, log_n, bitrev=True)
    if inverse:
        y = mont_mul_plain(SPEC, y, limbs_to_torch(j_field_ops(jfp.BLS12_381_FR).from_ints(
            [pow(1 << log_n, -1, SPEC.modulus)]), "cpu")[0])
    assert np.array_equal(limbs_to_numpy(y), want)


@pytest.mark.parametrize("s0,s1,bitrev", [(0, 1, False), (2, 5, False), (4, 7, True), (6, 7, True)])
def test_pease_stage_ranges_compose_single_stages(s0, s1, bitrev):
    """Stages s0 .. s1-1 of a (3, 128) batch == the loop of single plain
    stages (then the reversal gather), through the wrapper too."""
    y = limbs_to_torch(_mont_inputs(3 * 128, 700).reshape(3, 128, 16), "cpu")
    tw = _table(7)
    want = y
    for s in range(s0, s1):
        want = pease_stage_plain(SPEC, want, tw, s)
    if bitrev:
        rev = [int(format(i, "07b")[::-1], 2) for i in range(128)]
        want = want[:, rev]
    assert torch.equal(pease_stages_plain(SPEC, y, tw, s0, s1, bitrev), want)
    assert torch.equal(pease_stages(SPEC, y, tw, s0, s1, bitrev), want)
    if s1 == s0 + 1 and not bitrev:
        assert torch.equal(pease_stage(SPEC, y, tw, s0), want)


def test_pease_stages_rejects_empty_or_outside_ranges():
    y = limbs_to_torch(_mont_inputs(16, 701).reshape(1, 16, 16), "cpu")
    for s0, s1 in ((2, 2), (3, 1), (0, 5), (-1, 2)):
        with pytest.raises(ValueError):
            pease_stages(SPEC, y, _table(4), s0, s1)


@pytest.mark.parametrize("B", [1, 4])
def test_leaf_level_plain_matches_pallas_level(B):
    """One level of the fused NTT at log_m 6, leaf 3: the leaf with its
    level epilogue == tpu_ec's _leaf_apply, _twiddle_mul by the level
    table and the transpose, in interpret mode, on (64, B) columns."""
    from tpu_ec.ops.pallas.ntt_fused import FusedDomain as JFusedDomain
    from tpu_ec.ops.pallas.ntt_fused import _leaf_apply, _twiddle_mul
    from tpu_ec_torch.ops.ntt_fused import FusedDomain

    L = 16
    x = _mont_inputs(64 * B, 800 + B).reshape(64, B, L)  # (m, B, L)
    jdom = JFusedDomain(jfp.BLS12_381_FR, 6, False, leaf=3)
    xp = jnp.asarray(np.transpose(x, (2, 0, 1))).reshape(L, 8, 8 * B)
    y = _leaf_apply(jdom, xp, 3, True).reshape(L, 8, 8, B)
    T = jnp.asarray(jdom._inter_tw[(6, 3)])  # (L, n2, n1)
    y = _twiddle_mul(jdom, y, jnp.broadcast_to(T[..., None], y.shape), True)
    want = np.asarray(jnp.swapaxes(y, 1, 2).reshape(L, 8, 8 * B))  # (L, n1, n2 * B)

    tdom = FusedDomain(SPEC, 6, False, 3)
    Tt = limbs_to_torch(tdom.inter[(6, 3)], "cpu")  # (n2, n1, L)
    assert np.array_equal(tdom.inter[(6, 3)], np.transpose(jdom._inter_tw[(6, 3)], (1, 2, 0)))
    tx = limbs_to_torch(x.reshape(8, 8 * B, L), "cpu")
    tw = limbs_to_torch(tdom.leaf_tw[3], "cpu")
    got = ntt_leaf_plain(SPEC, tx, tw, level=(Tt, B))
    assert got.shape == (8, 8 * B, L)
    assert np.array_equal(limbs_to_numpy(got), np.transpose(want, (1, 2, 0)))
    assert torch.equal(ntt_leaf(SPEC, tx, tw, level=(Tt, B)), got)


def test_leaf_level_rejects_a_table_that_does_not_fit():
    x = limbs_to_torch(_mont_inputs(8 * 6, 802).reshape(8, 6, 16), "cpu")
    tw = torch.zeros((3, 4, 16), dtype=torch.int64)
    for T, B in ((torch.zeros((8, 3, 16), dtype=torch.int64), 4),  # 4 does not divide 6
                 (torch.zeros((8, 2, 16), dtype=torch.int64), 2),  # 6 / 2 = 3 columns of T
                 (torch.zeros((4, 3, 16), dtype=torch.int64), 2)):  # 4 rows, m = 8
        with pytest.raises(ValueError):
            ntt_leaf(SPEC, x, tw, level=(T, B))


def test_pease_route_keeps_its_tables_on_the_kernel():
    """The Pease route builds its master table once per (log_n, inverse,
    device) and reuses it on every later call."""
    k = FftKernel(SPEC, "cpu")
    x = limbs_to_torch(_mont_inputs(3 * 32, 900).reshape(3, 32, 16), "cpu")
    first = k.radix_fft_many(x)
    tables = {key: t for key, t in k._consts.items() if key[0] == "pease"}
    assert list(tables) == [("pease", 5, False, x.device)]
    assert torch.equal(k.radix_fft_many(x), first)
    k.radix_fft_many(x, inverse=True)
    assert k._consts[("pease", 5, False, x.device)] is tables[("pease", 5, False, x.device)]
    assert ("pease", 5, True, x.device) in k._consts
