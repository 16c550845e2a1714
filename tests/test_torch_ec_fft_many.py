"""The port's EC-FFT inverse and batched forms (ops/ec_fft.py), on the CPU.

- the inverse round trip at BLS12-381 n = 4 gives the input points back;
- ``radix_ec_fft_many`` at BN254 with a list of equal-length batches (one
  stacked run), a ragged list (one transform at a time, the abort hook
  polled before each) and a stacked (X, Y, Z) tuple of (B, n, L) tensors,
  each equal bit for bit to single ``radix_ec_fft`` calls; the hook aborts
  before any work; the functional ``radix_ec_fft`` equals the kernel's.

The forward transform itself is held against tpu_ec in
test_torch_ec_fft.py and test_torch_ec_fft_n8.py.  Inputs come from oracle
seeds; tolerance: none (integers).
"""

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from tpu_ec.curves import oracle
from tpu_ec.curves.params import BLS12_381_G1 as J_BLS
from tpu_ec.curves.params import BN254_G1 as J_BN
from tpu_ec_torch.curves import BLS12_381_G1, BN254_G1, PointOps
from tpu_ec_torch.errors import Aborted
from tpu_ec_torch.ops.ec_fft import EcFftKernel, radix_ec_fft


def _jacobian(ops, jspec, n, seed):
    return ops.to_jacobian(ops.from_affine_ints(oracle.random_points(jspec, n, seed=seed)))


def _equal(P, Q):
    return all(torch.equal(a, b) for a, b in zip(P, Q))


def test_inverse_round_trip_bls12_381():
    ops = PointOps(BLS12_381_G1, "cpu")
    pts = oracle.random_points(J_BLS, 4, seed=70)
    P = ops.to_jacobian(ops.from_affine_ints(pts))
    kern = EcFftKernel(BLS12_381_G1, "cpu")
    back = kern.radix_ec_fft(kern.radix_ec_fft(P), inverse=True)
    assert ops.to_affine_ints(ops.to_affine(back)) == pts


def test_radix_ec_fft_many_forms_match_single_calls():
    ops = PointOps(BN254_G1, "cpu")
    Pa, Pb, Pc = (_jacobian(ops, J_BN, n, s) for n, s in ((4, 71), (4, 72), (2, 73)))
    Pd = tuple(c[:1] for c in Pc)
    polls = []
    kern = EcFftKernel(BN254_G1, "cpu", maybe_abort=lambda: polls.append(1) and False)
    single = [kern.radix_ec_fft(P) for P in (Pa, Pb)]
    equal = kern.radix_ec_fft_many([Pa, Pb])
    assert len(equal) == 2 and all(_equal(g, w) for g, w in zip(equal, single)), "equal-length list"
    stacked = kern.radix_ec_fft_many(tuple(torch.stack(cs) for cs in zip(Pa, Pb)))
    assert all(c.shape == (2, 4, ops.L) for c in stacked)
    assert all(_equal(tuple(c[i] for c in stacked), single[i]) for i in range(2)), "stacked tuple"
    del polls[:]
    ragged = kern.radix_ec_fft_many([Pc, Pd])  # n = 2 and n = 1: their stages scale by w^0 = 1 only
    assert len(polls) == 2, "the ragged list polls abort before each transform"
    assert _equal(ragged[0], kern.radix_ec_fft(Pc)) and _equal(ragged[1], Pd), "ragged list"
    assert _equal(radix_ec_fft(BN254_G1, Pc, device="cpu"), ragged[0]), "functional entry"


def test_abort_hook_stops_before_any_work():
    ops = PointOps(BN254_G1, "cpu")
    P = _jacobian(ops, J_BN, 4, 74)
    kern = EcFftKernel(BN254_G1, "cpu", maybe_abort=lambda: True)
    for run in (lambda: kern.radix_ec_fft(P), lambda: kern.radix_ec_fft_many([P, P]),
                lambda: kern.radix_ec_fft_many([P, tuple(c[:2] for c in P)])):
        with pytest.raises(Aborted):
            run()
