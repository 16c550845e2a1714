"""Comparisons of the program's outputs with the reference's.

The program returns Jacobian points in Montgomery form (R = 2^(16 L)), G2
coordinates as c0 then c1; the reference gives affine points in plain
integers.  A point matches when X = x Z^2 and Y = y Z^3 (Z = 0 only for the
identity), so any Jacobian representative of the right point passes.
"""

from __future__ import annotations

import torch

from benchmark.reference.ec import Group
from benchmark.reference.limbs import LimbField, ints_to_limbs, limbs_to_ints
from benchmark.reference.params import CURVES


def plain_points(curve: str, coords) -> list:
    """The program's Jacobian batch (X, Y, Z), each (..., ext L) Montgomery
    limbs, as plain-integer (X, Y, Z) tuples (Fq2 values as pairs)."""
    c = CURVES[curve]
    L = c.q_limbs
    rinv = pow(1 << (16 * L), -1, c.q)
    cols = []
    for t in coords:
        t = t.reshape(-1, t.shape[-1])
        if c.ext == 1:
            cols.append([v * rinv % c.q for v in limbs_to_ints(t)])
        else:
            c0 = limbs_to_ints(t[:, :L])
            c1 = limbs_to_ints(t[:, L:])
            cols.append([(a * rinv % c.q, b * rinv % c.q) for a, b in zip(c0, c1)])
    return list(zip(*cols))


def points_wrong(curve: str, coords, expected: list) -> int:
    """How many points of the program's batch differ from ``expected``
    (affine plain ints, None = identity), one at a time in Python."""
    g = Group(CURVES[curve])
    got = plain_points(curve, coords)
    if len(got) != len(expected):
        return max(len(got), len(expected))
    return sum(not g.matches(P, A) for P, A in zip(got, expected))


def points_wrong_g1(curve: str, coords, expected_x: torch.Tensor, expected_y: torch.Tensor,
                    device) -> int:
    """``points_wrong`` for G1 batches on the device: ``expected_x``, ``_y``
    are (N, L) plain limbs of affine points none of which is the identity."""
    c = CURVES[curve]
    F = LimbField(c.q, c.q_limbs, device)
    X, Y, Z = (F.from_mont(t.reshape(-1, t.shape[-1]).to(device, torch.int64)) for t in coords)
    if X.shape[0] != expected_x.shape[0]:
        return max(X.shape[0], expected_x.shape[0])
    zz = F.mul(Z, Z)
    ok = (X == F.mul(expected_x, zz)).all(-1)
    ok &= (Y == F.mul(expected_y, F.mul(Z, zz))).all(-1)
    ok &= Z.any(-1)
    return int((~ok).sum())


def affine_limbs(curve: str, points: list, device) -> tuple[torch.Tensor, torch.Tensor]:
    """Affine G1 points (plain ints) -> (x, y) (N, L) int64 limbs."""
    L = CURVES[curve].q_limbs
    xs = torch.as_tensor(ints_to_limbs([p[0] for p in points], L), device=device)
    ys = torch.as_tensor(ints_to_limbs([p[1] for p in points], L), device=device)
    return xs, ys


def to_program_points(curve: str, points: list, device, dtype) -> tuple:
    """Affine plain-int points -> a Jacobian batch in the program's layout
    (Montgomery limbs, Z = R mod q): how the control stands in for the
    program."""
    c = CURVES[curve]
    L, R = c.q_limbs, 1 << (16 * c.q_limbs)
    mont = lambda v: v * R % c.q  # noqa: E731

    def col(vals):
        if c.ext == 1:
            return torch.as_tensor(ints_to_limbs([mont(v) for v in vals], L), device=device).to(dtype)
        return torch.cat([torch.as_tensor(ints_to_limbs([mont(v[i]) for v in vals], L), device=device)
                          for i in (0, 1)], dim=-1).to(dtype)

    one = 1 if c.ext == 1 else (1, 0)
    zero = 0 if c.ext == 1 else (0, 0)
    xs = [p[0] if p is not None else one for p in points]
    ys = [p[1] if p is not None else one for p in points]
    zs = [one if p is not None else zero for p in points]
    return col(xs), col(ys), col(zs)
