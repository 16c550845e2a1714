"""Kernel K2's plain version (the digit-NTT twiddle) against tpu_ec, bit-exact.

The same random GEMM columns (within the int32 accumulator bound
m * 37 * 127^2 of the largest leaf) and twiddles go through
``tpu_ec.ops.ntt_digit.inter_twiddle(interpret=True)`` and the port's
``inter_twiddle`` on the CPU.  Tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax.numpy as jnp
import numpy as np

from tpu_ec.fields import params as jfp
from tpu_ec.ops.ntt_digit import inter_twiddle as j_inter_twiddle
from tpu_ec_torch.convert import limbs_to_numpy
from tpu_ec_torch.errors import DeviceError
from tpu_ec_torch.fields import params as tfp
from tpu_ec_torch.kernels.inter import inter_twiddle, inter_twiddle_plain

N = 512
BOUND = (1 << 7) * 37 * 127 * 127  # leaf m = 2^7, 37 input digits


def _inputs(seed, const_t):
    rng = np.random.default_rng(seed)
    cols = rng.integers(0, BOUND, (37, N), dtype=np.int64)
    cols[:, 0] = BOUND - 1  # largest columns: the longest carry chains
    cols[:, 1] = 0
    spec = tfp.BLS12_381_FR
    shape = (16,) if const_t else (16, N)
    t = rng.integers(0, 1 << 16, shape, dtype=np.int64)
    t[-1] = rng.integers(0, int(spec.p_limbs[-1]), shape[1:])  # T < p
    return cols, t


@pytest.mark.parametrize(
    "canonical,const_t",
    [(False, False), (True, True), (False, True), (True, False)],
    ids=["per_element_to_int8", "const_t_canonical", "const_t_to_int8", "per_element_canonical"],
)
def test_inter_matches_tpu_ec(canonical, const_t):
    cols, t = _inputs(7 + 2 * canonical + const_t, const_t)
    want = np.asarray(
        j_inter_twiddle(
            jfp.BLS12_381_FR, jnp.asarray(cols.astype(np.int32)), jnp.asarray(t.astype(np.uint32)),
            canonical=canonical, const_t=const_t, interpret=True,
        )
    )
    got = inter_twiddle(  # the port takes (n, 16) twiddle rows, tpu_ec (16, n) planes
        tfp.BLS12_381_FR, torch.as_tensor(cols), torch.as_tensor(t if const_t else t.T.copy()),
        canonical=canonical, const_t=const_t,
    )
    assert got.dtype == (torch.int64 if canonical else torch.int8)
    assert got.shape == want.shape
    assert np.array_equal(got.numpy().astype(np.int64), want.astype(np.int64))


def test_inter_values_vs_bigint():
    """u = v * t * 2^-288 mod p with v = sum_e cols[e] 2^(7e) (canonical)."""
    spec = tfp.BLS12_381_FR
    p = spec.modulus
    cols, t = _inputs(3, False)
    got = limbs_to_numpy(
        inter_twiddle_plain(spec, torch.as_tensor(cols), torch.as_tensor(t.T.copy()), canonical=True).T
    )
    rinv = pow(1 << 288, -1, p)
    for j in (0, 1, 2, N - 1):
        v = sum(int(cols[e, j]) << (7 * e) for e in range(37))
        tv = sum(int(t[i, j]) << (16 * i) for i in range(16))
        assert sum(int(x) << (16 * i) for i, x in enumerate(got[j])) == (v * tv * rinv) % p


def test_non_cpu_tensor_never_takes_the_plain_version():
    cols = torch.zeros((37, 8), dtype=torch.int32, device="meta")
    t = torch.zeros((16, 8), dtype=torch.int32, device="meta")
    with pytest.raises(DeviceError):
        inter_twiddle(tfp.BLS12_381_FR, cols, t)
