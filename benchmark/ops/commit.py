"""A KZG commit: ``CommitPipeline(curve).commit(coeffs, bases)``, NTT ->
from_mont -> MSM (tpu_ec_torch/ops/pipeline.py).

Inputs: a pool of ``pool`` coefficient vectors of 2^log_n Fr elements in
Montgomery form, cycled, and 2^log_n fixed affine bases k_i G.

Check: every op's commitment, and the evaluations of ``check_sample`` ops
drawn from the seed, against the reference: its own NTT of the same
coefficients on the card (plain PyTorch limbs), and (sum_i e_i k_i) G in
Python integers, e_i the plain evaluations.  Control: the same reference
with each scalar e_i cut to its low (bits - 1) bits.
"""

from __future__ import annotations

import torch

from benchmark.checks import points_wrong, to_program_points
from benchmark.program import ProgramOp, dot_mod, generator, limbs_below, make_bases, program_curve, storage
from benchmark.reference.ec import Group
from benchmark.reference.limbs import LimbField
from benchmark.reference.params import CURVES


class Op(ProgramOp):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from tpu_ec_torch.ops.pipeline import CommitPipeline

        self.curve = traffic["curve"]
        self.ref = CURVES[self.curve]
        self.log_n = traffic["log_n"]
        gen = generator(seed, self.device)
        self.bases, self.k = make_bases(self.curve, gen, self.log_n, self.device)
        n, L = 1 << self.log_n, self.ref.r_limbs
        self.coeffs = storage(limbs_below(gen, (self.pool, n), self.ref.r, L, self.device), self.device)
        self.pipe = CommitPipeline(program_curve(self.curve), self.device)

    def call(self, i):
        return self.pipe.commit(self.coeffs[i], self.bases)

    def keep(self, out):
        evals, commitment = out
        return commitment, evals

    def release(self):
        self.pipe = self.bases = None

    # -- the reference ------------------------------------------------------

    def _reference(self, items):
        """{pool item: (Montgomery evaluations (n, L) int64, sum e_i k_i mod r)}."""
        r = self.ref.r
        Fr = LimbField(r, self.ref.r_limbs, self.device)
        omega = self.ref.root_of_unity(self.log_n)
        rinv = pow(Fr.R, -1, r)
        out = {}
        for p in items:
            ev = Fr.ntt(self.coeffs[p].to(torch.int64), omega)
            out[p] = (ev, dot_mod(ev, self.k, r)[0] * rinv % r)
        return out

    def check(self, small, sampled):
        items = sorted({i % self.pool for i, _ in small} | {i % self.pool for i, _ in sampled})
        ref = self._reference(items)
        g = Group(self.ref)
        want = {p: g.to_affine_many([g.scalar_mul(self.ref.gen, s)])[0] for p, (_, s) in ref.items()}
        commit_wrong = sum(points_wrong(self.curve, C, [want[i % self.pool]]) for i, C in small)
        evals_wrong = sum(int((e.to(torch.int64) != ref[i % self.pool][0]).any(-1).sum()) for i, e in sampled)
        return [("commitments_wrong", commit_wrong, 0), ("eval_rows_wrong", evals_wrong, 0)]

    def control(self, small, sampled):
        """The reference in the program's place, at one bit less of scalar
        precision: (small, sampled) as the program's would be."""
        items = sorted({i % self.pool for i, _ in small} | {i % self.pool for i, _ in sampled})
        r, L = self.ref.r, self.ref.r_limbs
        Fr = LimbField(r, L, self.device)
        ref = self._reference(items)
        g = Group(self.ref)
        top = r.bit_length() - 1
        cut = {}
        for p, (ev, _) in ref.items():
            plain = Fr.from_mont(ev)
            plain[:, top // 16] &= (1 << (top % 16)) - 1
            s = dot_mod(plain, self.k, r)[0]
            cut[p] = to_program_points(self.curve, g.to_affine_many([g.scalar_mul(self.ref.gen, s)]),
                                       self.device, self.coeffs.dtype)
        return ([(i, cut[i % self.pool]) for i, _ in small],
                [(i, ref[i % self.pool][0]) for i, _ in sampled])
