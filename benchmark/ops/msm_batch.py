"""A batch of MSMs: ``MultiexpKernel(curve).multiple_multiexp(bases, scalars,
chunks)`` (tpu_ec_torch/ops/msm.py), chunk c over rows [c m, (c + 1) m).

Inputs: 2^base_log_n distinct affine bases k_i G tiled ``tile`` times into
the batch's rows, and a pool of ``pool`` scalar vectors, cycled.

Check: every chunk's point of every op against (sum over the chunk of
s_i k_i) G, from the reference's fixed-base table (Python integers).
Control: the same with each scalar cut to its low (bits - 1) bits, in the
program's place.
"""

from __future__ import annotations

import torch

from benchmark.checks import affine_limbs, points_wrong_g1, to_program_points
from benchmark.program import ProgramOp, dot_mod, generator, limbs_below, make_bases, program_curve, storage
from benchmark.reference.ec import FixedBase, Group
from benchmark.reference.params import CURVES


class Op(ProgramOp):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from tpu_ec_torch.ops.msm import MultiexpKernel

        self.curve = traffic["curve"]
        self.ref = CURVES[self.curve]
        if self.ref.ext != 1:
            raise ValueError("the batch check is written for G1")
        self.chunks = traffic["chunks"]
        gen = generator(seed, self.device)
        bases, k = make_bases(self.curve, gen, traffic["base_log_n"], self.device)
        tile = traffic["tile"]
        self.bases = tuple(c.repeat(tile, 1) for c in bases)
        self.k = k.repeat(tile, 1)
        del bases
        n, L = self.k.shape[0], self.ref.r_limbs
        if n % self.chunks:
            raise ValueError(f"{n} rows do not split into {self.chunks} chunks")
        self.scalars = storage(limbs_below(gen, (self.pool, n), self.ref.r, L, self.device), self.device)
        self.msm = MultiexpKernel(program_curve(self.curve), self.device)

    def call(self, i):
        return self.msm.multiple_multiexp(self.bases, self.scalars[i], self.chunks)

    def keep(self, out):
        return out, None

    def release(self):
        self.msm = self.bases = None

    def _want(self, items, cut_top_bit=False) -> dict:
        """{pool item: affine chunk results (plain ints)}."""
        r = self.ref.r
        top = r.bit_length() - 1
        fb = FixedBase(Group(self.ref), self.ref.gen)
        k = self.k.reshape(self.chunks, -1, self.k.shape[-1])
        out = {}
        for p in items:
            s = self.scalars[p].to(k.device, torch.int64, copy=True)
            if cut_top_bit:
                s[:, top // 16] &= (1 << (top % 16)) - 1
            out[p] = fb.mul_many(dot_mod(s.reshape(self.chunks, -1, s.shape[-1]), k, r))
        return out

    def check(self, small, sampled):
        want = {p: affine_limbs(self.curve, w, self.device)
                for p, w in self._want(sorted({i % self.pool for i, _ in small})).items()}
        wrong = sum(points_wrong_g1(self.curve, P, *want[i % self.pool], self.device) for i, P in small)
        return [("chunks_wrong", wrong, 0)]

    def control(self, small, sampled):
        want = self._want(sorted({i % self.pool for i, _ in small}), cut_top_bit=True)
        pts = {p: to_program_points(self.curve, w, self.device, self.scalars.dtype) for p, w in want.items()}
        return [(i, pts[i % self.pool]) for i, _ in small], sampled
