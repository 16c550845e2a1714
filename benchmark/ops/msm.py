"""One MSM: ``MultiexpKernel(curve).multiexp(bases, scalars)`` with the
"auto" engine (tpu_ec_torch/ops/msm.py; the pair engine, on G1 and G2).

Inputs: 2^log_n fixed affine bases k_i G and a pool of ``pool`` scalar
vectors (plain Fr limbs), cycled.

Check: every op's point against (sum_i s_i k_i) G, in Python integers
(Fq2 on G2).  Control: the same with each scalar cut to its low (bits - 1)
bits, in the program's place.
"""

from __future__ import annotations

import torch

from benchmark.checks import points_wrong, to_program_points
from benchmark.program import ProgramOp, dot_mod, generator, limbs_below, make_bases, program_curve, storage
from benchmark.reference.ec import Group
from benchmark.reference.params import CURVES


class Op(ProgramOp):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from tpu_ec_torch.ops.msm import MultiexpKernel

        self.curve = traffic["curve"]
        self.ref = CURVES[self.curve]
        gen = generator(seed, self.device)
        self.bases, self.k = make_bases(self.curve, gen, traffic["log_n"], self.device)
        n, L = self.k.shape[0], self.ref.r_limbs
        self.scalars = storage(limbs_below(gen, (self.pool, n), self.ref.r, L, self.device), self.device)
        self.msm = MultiexpKernel(program_curve(self.curve), self.device)

    def call(self, i):
        return self.msm.multiexp(self.bases, self.scalars[i])

    def keep(self, out):
        return out, None

    def release(self):
        self.msm = self.bases = None

    def _want(self, items, cut_top_bit=False):
        g, r = Group(self.ref), self.ref.r
        top = r.bit_length() - 1
        out = {}
        for p in items:
            s = self.scalars[p].to(self.k.device, torch.int64, copy=True)
            if cut_top_bit:
                s[:, top // 16] &= (1 << (top % 16)) - 1
            out[p] = g.to_affine_many([g.scalar_mul(self.ref.gen, dot_mod(s, self.k, r)[0])])
        return out

    def check(self, small, sampled):
        want = self._want(sorted({i % self.pool for i, _ in small}))
        return [("points_wrong", sum(points_wrong(self.curve, P, want[i % self.pool]) for i, P in small), 0)]

    def control(self, small, sampled):
        want = self._want(sorted({i % self.pool for i, _ in small}), cut_top_bit=True)
        pts = {p: to_program_points(self.curve, w, self.device, self.scalars.dtype) for p, w in want.items()}
        return [(i, pts[i % self.pool]) for i, _ in small], sampled
