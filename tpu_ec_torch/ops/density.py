"""Sparsity tracking for R1CS-style MSMs.

PyTorch counterpart of ``tpu_ec/ops/density.py`` (the reference prover's
``QueryDensity`` / ``FullDensity`` / ``DensityTracker``,
``ec-gpu-proxy/src/multiexp_cpu.rs:85-207``, and its ``(bases, skip)``
source convention, ``:16-83``).  The density mask is built on the host in
numpy; :func:`compact_by_density` gathers the touched terms with
``index_select`` on the tensors' own device, once, and the dense remainder
goes to the normal MSM: sparsity is a pre-pass, not a per-element branch.
"""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from ..utils.timer import phase


class FullDensity:
    """Marker: every term present (multiexp_cpu.rs:97-116)."""

    def get_query_size(self) -> int | None:
        return None

    def generate_mask(self, n: int) -> np.ndarray:
        return np.ones(n, dtype=bool)


@dataclasses.dataclass
class DensityTracker:
    """Bitmask of touched terms (multiexp_cpu.rs:130-207).  ``bv`` holds one
    byte a term (0 or 1), so the mask of a 2^20-term query is a view of it,
    not a conversion of 2^20 Python objects (~40 ms)."""

    bv: bytearray = dataclasses.field(default_factory=bytearray)
    total_density: int = 0

    def __post_init__(self):
        self.bv = bytearray(self.bv)

    def add_element(self) -> None:
        self.bv.append(0)

    def inc(self, idx: int) -> None:
        if not self.bv[idx]:
            self.bv[idx] = 1
            self.total_density += 1

    def get_query_size(self) -> int:
        return len(self.bv)

    def get_total_density(self) -> int:
        return self.total_density

    def extend(self, other: "DensityTracker", is_input_density: bool) -> None:
        """Merge two trackers (multiexp_cpu.rs:160-206): the input densities
        of the merged system OR together at index 0 (the constant-one
        variable), and the rest of ``other`` is appended; aux densities
        concatenate."""
        if not self.bv:
            self.bv = bytearray(other.bv)
            self.total_density = other.total_density
            return
        tail = other.bv
        if is_input_density and other.bv:
            if other.bv[0] and not self.bv[0]:
                self.bv[0] = 1
                self.total_density += 1
            tail = other.bv[1:]
        self.bv.extend(tail)
        self.total_density += sum(tail)

    def generate_mask(self, n: int) -> np.ndarray:
        if n != len(self.bv):
            raise ValueError(f"density length mismatch: {len(self.bv)} tracked, {n} terms")
        return np.frombuffer(self.bv, dtype=np.uint8).astype(bool)


def compact_by_density(density, bases, scalars: torch.Tensor, skip: int = 0):
    """The terms a density query touches: ``scalars[i]`` and ``bases[i +
    skip]`` for every set index i of the mask (``skip``: the bases offset
    of multiexp.rs:376-378).  ``bases`` is a tuple of coordinate tensors;
    returns (bases', scalars') on their devices, ready for
    ``MultiexpKernel.multiexp``."""
    (idx,) = np.nonzero(density.generate_mask(scalars.shape[0]))
    with phase("wait/upload_index"):  # a copy from pageable host memory
        sidx = torch.as_tensor(idx, dtype=torch.int64, device=scalars.device)
        bidx = torch.as_tensor(idx + skip, dtype=torch.int64, device=bases[0].device)
    return tuple(c.index_select(0, bidx) for c in bases), scalars.index_select(0, sidx)
