"""Carry values across between the JAX package and the port.

``tpu_ec`` hands out numpy ``uint32 (n, L)`` arrays of 16-bit half-limbs;
the port holds the same values as ``(n, L)`` tensors, int64 on the CPU and
int32 on CUDA.  An Fq2 value (a G2 coordinate) is a pair (c0, c1) of such
arrays in tpu_ec and one ``(n, 2L)`` tensor, c0 then c1, in the port.  Only
values cross, never device buffers: this module imports neither jax nor
tpu_ec.
"""

from __future__ import annotations

import numpy as np
import torch

from .fields.limbs import resolve_device, storage_dtype
from .fields.params import int_to_limbs, limbs_to_int


def limbs_to_torch(arr, device="cuda") -> torch.Tensor:
    """numpy (n, L) half-limbs (any integer dtype, values < 2^16) -> port tensor."""
    device = resolve_device(device)
    a = np.asarray(arr)
    if a.size and (a.min() < 0 or a.max() >= 1 << 16):
        raise ValueError("half-limbs must lie in [0, 2^16)")
    return torch.as_tensor(a.astype(np.int64), device=device).to(storage_dtype(device))


def limbs_to_numpy(t: torch.Tensor) -> np.ndarray:
    """Port tensor -> numpy uint32 half-limbs, the layout tpu_ec takes."""
    return t.detach().to("cpu", torch.int64).numpy().astype(np.uint32)


def points_to_torch(pts, device="cuda") -> tuple:
    """Affine (x, y) (or Jacobian) numpy coordinate tuple -> port tuple."""
    return tuple(limbs_to_torch(c, device) for c in pts)


def points_to_numpy(pts) -> tuple:
    return tuple(limbs_to_numpy(c) for c in pts)


def fp2_to_torch(pair, device="cuda") -> torch.Tensor:
    """tpu_ec Fq2 pair (c0, c1) of (..., L) half-limbs -> port (..., 2L) tensor."""
    return torch.cat([limbs_to_torch(pair[0], device), limbs_to_torch(pair[1], device)], dim=-1)


def fp2_to_numpy(t: torch.Tensor) -> tuple:
    """Port (..., 2L) Fq2 tensor -> tpu_ec's (c0, c1) pair of uint32 arrays."""
    a = limbs_to_numpy(t)
    L = a.shape[-1] // 2
    return (a[..., :L].copy(), a[..., L:].copy())


def g2_points_to_torch(pts, device="cuda") -> tuple:
    """tpu_ec G2 affine (x, y) (or Jacobian) of (c0, c1) pairs -> port tuple
    of (..., 2L) tensors."""
    return tuple(fp2_to_torch(c, device) for c in pts)


def g2_points_to_numpy(pts) -> tuple:
    """Port G2 coordinate tuple -> tpu_ec's tuple of (c0, c1) numpy pairs."""
    return tuple(fp2_to_numpy(c) for c in pts)


def ints_to_limbs(values, n_limbs: int, device="cuda") -> torch.Tensor:
    """Plain non-negative Python ints -> (n, n_limbs) limb tensor (no
    Montgomery conversion)."""
    arr = np.stack([int_to_limbs(int(v), n_limbs) for v in values]) if len(values) else (
        np.zeros((0, n_limbs), np.uint32)
    )
    return limbs_to_torch(arr, device)


def limbs_to_ints(t: torch.Tensor) -> list[int]:
    """(n, L) limb tensor -> plain Python ints (no Montgomery conversion)."""
    return [limbs_to_int(r) for r in limbs_to_numpy(t).reshape(-1, t.shape[-1])]
