"""What the ops share: the program's public entries, the seeded inputs, and
the base class of an op.

Inputs come from the seed through one ``torch.Generator`` on the device, in
a few large calls.  Bases are k G with k = a_i + c_j: the program's own
scalar multiplication makes 2 sqrt(n) points a_i G and c_j G, and one batched
point add of every pair gives the n bases, which ``to_affine`` normalises.
The check never trusts them: it holds the program's result against (sum of
scalar times k) G, worked out from k alone.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference.params import CURVES

LIMB = 1 << 16


def generator(seed: int, device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(seed)
    return g


def limbs_below(gen, shape, modulus: int, L: int, device) -> torch.Tensor:
    """Uniform int64 limbs (shape + (L,)) of values below ``modulus``: the
    top limb is drawn below the modulus' top limb."""
    top = modulus >> (16 * (L - 1))
    x = torch.randint(0, LIMB, tuple(shape) + (L,), generator=gen, device=device, dtype=torch.int64)
    x[..., L - 1] = torch.randint(0, top, tuple(shape), generator=gen, device=device, dtype=torch.int64)
    return x


def storage(t: torch.Tensor, device) -> torch.Tensor:
    """The program's limb dtype: int32 on the card, int64 on the CPU."""
    return t.to(torch.int32 if torch.device(device).type == "cuda" else torch.int64).contiguous()


def program_curve(name: str):
    from tpu_ec_torch.curves import params

    return getattr(params, name.upper())


def make_bases(curve: str, gen, log_n: int, device):
    """n = 2^log_n affine bases k_i G (the program's coordinates) and k as
    (n, 5) int64 limbs on the device: k = a_i + c_j, a and c 64-bit."""
    from tpu_ec_torch.curves.point import PointOps

    ref = CURVES[curve]
    ops = PointOps(program_curve(curve), device)
    m1, m2 = 1 << (log_n - log_n // 2), 1 << (log_n // 2)
    ac = torch.randint(0, LIMB, (m1 + m2, 4), generator=gen, device=device, dtype=torch.int64)
    k16 = torch.zeros((m1 + m2, ref.r_limbs), dtype=torch.int64, device=device)
    k16[:, :4] = ac
    G = ops.to_jacobian(ops.generator_affine)
    P = tuple(c.expand(m1 + m2, -1).contiguous() for c in G)
    AC = ops.scalar_mul(P, storage(k16, device))
    A = tuple(c[:m1].repeat_interleave(m2, 0) for c in AC)
    C = tuple(c[m1:].repeat(m1, 1) for c in AC)
    bases = ops.to_affine(ops.add(A, C))
    del AC, A, C, P
    k = torch.zeros((m1 * m2, 5), dtype=torch.int64, device=device)
    k[:, :4] = ac[:m1].repeat_interleave(m2, 0) + ac[m1:].repeat(m1, 1)
    for j in range(4):  # carries of the limb-wise sum
        k[:, j + 1] += k[:, j] >> 16
        k[:, j] &= 0xFFFF
    return tuple(c.contiguous() for c in bases), k


def dot_mod(s: torch.Tensor, k: torch.Tensor, modulus: int, block: int = 1 << 16) -> list[int]:
    """sum_i s_i k_i mod ``modulus`` along axis -2 of (..., n, Ls) and
    (..., n, Lk) int64 16-bit limbs: one int per leading index (one for none)."""
    s2 = s.reshape(-1, *s.shape[-2:])
    k2 = k.reshape(-1, *k.shape[-2:]).to(s.device)
    B, n = s2.shape[:2]
    cols = torch.zeros((B, s.shape[-1], k.shape[-1]), dtype=torch.int64, device=s.device)
    rows = min(n, block)
    per = max(1, block // rows)
    for b0 in range(0, B, per):
        for lo in range(0, n, rows):  # column sums stay below 2^52 for n <= 2^20
            a, c = s2[b0 : b0 + per, lo : lo + rows], k2[b0 : b0 + per, lo : lo + rows]
            cols[b0 : b0 + per] += (a[..., :, None] * c[..., None, :]).sum(1)
    out = []
    for c in cols.cpu().numpy():
        v = 0
        for (i, j), x in np.ndenumerate(c):
            v += int(x) << (16 * (i + j))
        out.append(v % modulus)
    return out


def preload_kernels() -> None:
    """Build (on a checkout's first run) and load the program's kernel
    library, so that the ranks of a multi-rank cell, spawned after this, find
    it built rather than running nvcc side by side."""
    from tpu_ec_torch.kernels.build import load

    load()


class ProgramOp:
    """Base of an op: the program's counters and kernel names."""

    def __init__(self, config: dict, traffic: dict, seed: int, device):
        self.config, self.traffic, self.seed = config, traffic, seed
        self.device = torch.device(device)
        self.pool = traffic.get("pool", 1)

    def launch_counts(self) -> dict:
        from tpu_ec_torch.kernels import launch_counters

        return launch_counters()

    def hand_kernel_names(self) -> set:
        """Function names of the program's hand-written CUDA kernels, from its
        build's ``-Xptxas -v`` report."""
        from benchmark.trace import mangled_idents

        if self.device.type != "cuda":
            return set()
        from tpu_ec_torch.kernels.build import ptxas_report

        return mangled_idents(ptxas_report())

    def release(self) -> None:
        """Drop the program's objects and inputs the check does not need."""
