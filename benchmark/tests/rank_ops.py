"""Ops for the tests of multi-rank cells, at module level so that spawned
ranks can import them: an all-reduce over the program's mesh, and the same
with a fault planted on one rank."""

from __future__ import annotations

import os
import time

import torch

from benchmark.program import ProgramOp


class AllReduceOp(ProgramOp):
    """Each rank's pool of ``size`` int64 values, drawn from (seed, rank);
    an op sums one of them over the mesh that the program finds in the
    default process group (``tpu_ec_torch.parallel.mesh.Mesh``), one
    all-reduce.  Check: every element of every op's sum against the sum of
    every rank's values, which each rank draws again from the seed.

    The traffic's ``pid_dir``, where given, gets a file a rank holding its
    process id."""

    def __init__(self, config, traffic, seed, device):
        super().__init__(config, traffic, seed, device)
        from tpu_ec_torch.parallel.mesh import Mesh

        self.mesh = Mesh()
        self.size = traffic["size"]
        self.x = self.draw(self.mesh.rank).to(self.device)
        self.calls = 0
        if "pid_dir" in traffic:
            with open(os.path.join(traffic["pid_dir"], f"rank{self.mesh.rank}.pid"), "w") as f:
                f.write(str(os.getpid()))

    def draw(self, rank: int) -> torch.Tensor:
        g = torch.Generator().manual_seed((self.seed * 65537 + rank) % 2**63)
        return torch.randint(0, 1 << 40, (self.pool, self.size), generator=g, dtype=torch.int64)

    def call(self, i):
        self.calls += 1
        y = self.x[i].clone()
        torch.distributed.all_reduce(y, group=self.mesh.group)
        return y

    def keep(self, out):
        return out.cpu(), None

    def check(self, small, sampled):
        want = sum(self.draw(r) for r in range(self.mesh.size))
        return [("elements_wrong", sum(int((y != want[i % self.pool]).sum()) for i, y in small), 0)]

    def control(self, small, sampled):
        """The sum in the program's place, in int32, the width below."""
        low = sum(self.draw(r).to(torch.int32) for r in range(self.mesh.size)).to(torch.int64)
        return [(i, low[i % self.pool]) for i, _ in small], sampled

    def launch_counts(self) -> dict:
        return {}

    def hand_kernel_names(self) -> set:
        return set()

    def release(self) -> None:
        self.x = None


class WrongOnRank1(AllReduceOp):
    """Rank 1 alters one element of every sum it returns."""

    def call(self, i):
        y = super().call(i)
        if self.mesh.rank == 1:
            y[0] += 1
        return y


class RaisesOnRank2(AllReduceOp):
    """Rank ``RAISES`` (2; 0 in ``RaisesOnRank0``) raises on its third op (the warm-up's counted), after
    writing the time to ``pid_dir``/raised; the other ranks go on into the
    all-reduce and wait there."""

    RAISES = 2

    def call(self, i):
        if self.mesh.rank == self.RAISES and self.calls == 2:
            with open(os.path.join(self.traffic["pid_dir"], "raised"), "w") as f:
                f.write(repr(time.time()))
            raise RuntimeError(f"planted: rank {self.RAISES} raises on its third op")
        return super().call(i)


class RaisesOnRank0(RaisesOnRank2):
    RAISES = 0
