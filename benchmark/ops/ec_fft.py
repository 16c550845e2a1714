"""A batch of EC-group FFTs: ``EcFftKernel(curve).radix_ec_fft_many`` on a
(transforms, 2^log_n) batch of Jacobian points, forward (tpu_ec_torch/ops/ec_fft.py).

Inputs: a pool of ``pool`` batches.  Each output is chosen first: d (the
discrete logs of the outputs) is drawn from the seed in [1, 2^16), a = the
inverse NTT of d (reference), and the inputs are a_i G, made by the
program's scalar multiplication.  The work of a transform depends on its
twiddles only, not on the points.

Check: every output point of ``check_sample`` ops drawn from the seed
equals d G, from a table of the reference's (Python integers).  Control:
the reference's transform with every twiddle cut to its low (bits - 1)
bits, in the program's place.
"""

from __future__ import annotations

import torch

from benchmark.checks import affine_limbs, points_wrong_g1, to_program_points
from benchmark.program import ProgramOp, generator, program_curve, storage
from benchmark.reference.ec import FixedBase, Group
from benchmark.reference.limbs import LimbField, limbs_to_ints
from benchmark.reference.params import CURVES

D_BITS = 16


class Op(ProgramOp):
    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from tpu_ec_torch.curves.point import PointOps
        from tpu_ec_torch.ops.ec_fft import EcFftKernel

        self.curve = traffic["curve"]
        self.ref = CURVES[self.curve]
        if self.ref.ext != 1:
            raise ValueError("the EC-FFT check is written for G1")
        self.log_n, self.batch = traffic["log_n"], traffic["transforms"]
        n = 1 << self.log_n
        gen = generator(seed, self.device)
        self.d = torch.randint(1, 1 << D_BITS, (self.pool, self.batch, n), generator=gen, device=self.device,
                               dtype=torch.int64)
        r, L = self.ref.r, self.ref.r_limbs
        Fr = LimbField(r, L, self.device)
        d_limbs = torch.zeros(self.d.shape + (L,), dtype=torch.int64, device=self.device)
        d_limbs[..., 0] = self.d
        a = Fr.mul(Fr.ntt(d_limbs, pow(self.ref.root_of_unity(self.log_n), -1, r)), Fr.const(pow(n, -1, r)))
        ops = PointOps(program_curve(self.curve), self.device)
        G = ops.to_jacobian(ops.generator_affine)
        P = tuple(c.expand(a.shape[:-1] + c.shape[-1:]).contiguous() for c in G)
        self.inputs = [tuple(c[p].contiguous() for c in ops.scalar_mul(P, storage(a, self.device)))
                       for p in range(self.pool)]
        self.dtype = self.inputs[0][0].dtype
        self.fft = EcFftKernel(program_curve(self.curve), self.device)

    def call(self, i):
        return self.fft.radix_ec_fft_many(self.inputs[i])

    def keep(self, out):
        return None, out

    def release(self):
        self.fft = self.inputs = None

    def check(self, small, sampled):
        g = Group(self.ref)
        table = g.multiples(self.ref.gen, 1 << D_BITS)
        x, y = affine_limbs(self.curve, [table[1]] + table[1:], self.device)  # row 0 unused: d >= 1
        wrong = 0
        for i, out in sampled:
            d = self.d[i % self.pool].reshape(-1)
            wrong += points_wrong_g1(self.curve, out, x[d], y[d], self.device)
        return [("points_wrong", wrong, 0)]

    def control(self, small, sampled):
        """The reference's transform of the same inputs with every twiddle cut
        by its top bit, in the program's place."""
        r, L, n = self.ref.r, self.ref.r_limbs, 1 << self.log_n
        Fr = LimbField(r, L, self.device)
        top = r.bit_length() - 1
        omega = self.ref.root_of_unity(self.log_n)
        twiddles = [pow(omega, j, r) & ((1 << top) - 1) for j in range(max(n // 2, 1))]
        table = Fr.tensor([t * Fr.R for t in twiddles])
        fb = FixedBase(Group(self.ref), self.ref.gen)
        out = {}
        for p in sorted({i % self.pool for i, _ in sampled}):
            d_limbs = torch.zeros(self.d[p].shape + (L,), dtype=torch.int64, device=self.device)
            d_limbs[..., 0] = self.d[p]
            a = Fr.mul(Fr.ntt(d_limbs, pow(omega, -1, r)), Fr.const(pow(n, -1, r)))
            cut = limbs_to_ints(Fr.ntt(a, omega, table=table))
            pts = to_program_points(self.curve, fb.mul_many(cut), self.device, self.dtype)
            out[p] = tuple(c.reshape(self.batch, n, -1) for c in pts)
        return small, [(i, out[i % self.pool]) for i, _ in sampled]
