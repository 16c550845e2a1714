"""A run with the timed path broken underneath comes out not correct, and
the control (the reference at one bit less of scalar precision, in the
program's place) fails the check: on the CPU, at tiny sizes, through the
program's plain versions.  The card-size readings are benchmark/control.py's."""

import pytest
import torch

from benchmark import control
from benchmark import run as R
from benchmark.tests.test_bench_harness import CELLS, TINY

CPU = torch.device("cpu")


def cell(op):
    return R.Cell(CELLS[op], R.benchmark_spec(), TINY[op])


def altered(out):
    """The first coordinate's lowest limb of the first point, changed."""
    X = out[0].clone()
    X.view(-1, X.shape[-1])[0, 0] ^= 1
    return (X, *out[1:])


def faulty(op, fault):
    base = R.load_module("ops", op).Op

    class Broken(base):
        def call(self, i):
            if op == "commit":
                fr = self.pipe.fr
                n = self.coeffs.shape[1]
                if fault == "altered":
                    evals, C = super().call(i)
                    return evals, altered(C)
                if fault == "half":
                    evals, _ = super().call(i)
                    h = n // 2
                    return evals, self.pipe.msm.multiexp(tuple(b[:h] for b in self.bases), fr.from_mont(evals[:h]))
                coeffs = self.coeffs[i]  # "unchanged": the NTT returns its input
                return coeffs, self.pipe.msm.multiexp(self.bases, fr.from_mont(coeffs))
            if op == "ec_fft":
                if fault == "unchanged":
                    return self.inputs[i]
                out = super().call(i)
                if fault == "altered":
                    return altered(out)
                h = out[0].shape[0] // 2  # "half": the second half of the transforms left out
                return tuple(torch.cat([o[:h], x[h:]]) for o, x in zip(out, self.inputs[i]))
            if op == "msm":
                if fault == "altered":
                    return altered(super().call(i))
                h = self.bases[0].shape[0] // 2
                return self.msm.multiexp(tuple(b[:h] for b in self.bases), self.scalars[i][:h])
            if fault == "altered":  # msm_batch
                return altered(super().call(i))
            h, rows = self.chunks // 2, self.bases[0].shape[0] // 2
            part = self.msm.multiple_multiexp(tuple(b[:rows] for b in self.bases), self.scalars[i][:rows], h)
            return tuple(torch.cat([p, torch.zeros_like(p)]) for p in part)

    return Broken


FAULTS = [("commit", "altered"), ("commit", "half"), ("commit", "unchanged"),
          ("ec_fft", "altered"), ("ec_fft", "half"), ("ec_fft", "unchanged"),
          ("msm", "altered"), ("msm", "half"), ("msm_batch", "altered"), ("msm_batch", "half")]


@pytest.mark.parametrize("op,fault", FAULTS)
def test_a_broken_path_is_not_correct(op, fault):
    line, checks = R.run_cell(cell(op), 2**31 + 77, 0.05, False, CPU, op_class=faulty(op, fault))
    assert line["failed"] == 0 and line["attempted"] >= 1
    assert not line["correct"], checks
    assert any(v > lim for _, v, lim in checks)


@pytest.mark.parametrize("op", sorted(CELLS))
def test_the_control_fails_and_the_program_passes(op):
    r = control.readings(cell(op), 2**31 + 91, 0.05, CPU)
    assert r["ops"] >= 1
    assert all(v == 0 for v in r["program"].values()), r
    assert any(v > 0 for v in r["control"].values()), r
