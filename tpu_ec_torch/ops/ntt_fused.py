"""Fused NTT: recursive four-step with block-resident leaf transforms.

PyTorch counterpart of ``tpu_ec/ops/pallas/ntt_fused.py`` (the
``ntt_impl="fused"`` route of ``FftKernel``).  The transform of
n = n1 * n2 points, viewed as (n2, n1) with j = j1 + n1 * j2, is

  1. an n2-point NTT along axis 0 (root w^n1), a leaf;
  2. times the twiddle T[k2, j1] = w^(k2 j1);
  3. a transpose to (n1, n2);
  4. an n1-point NTT along axis 0, recursively;
  5. a row-major flatten: X[k2 + n2 k1] = Z[k1, k2], natural order.

Steps 1-3 are one launch of kernel K4 with its level epilogue; the
innermost leaf has none.  Each leaf (at most 2^leaf points, config
``ntt_leaf_log``) runs all its stages in one launch with its columns in
shared memory.  Tensors are
(m, B, L) rows: the transform runs along axis 0, batched over B.  The
level twiddle tables are built once on the host and kept in the disk cache
beside the digit NTT's (64 MB for the first level at 2^20).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..config import get_config
from ..fields.fp import FieldOps
from ..fields.limbs import storage_dtype
from ..fields.params import FieldSpec
from ..kernels.ntt_leaf import MAX_LEAF_LOG, ntt_leaf
from ..utils.timer import phase
from .ntt import get_domain, twiddle_table_np
from .ntt_digit import cached_table, inter_table_np


class FusedDomain:
    """Constant tables of one (field, log_n, inverse, leaf) fused NTT."""

    def __init__(self, spec: FieldSpec, log_n: int, inverse: bool, leaf: int):
        if not 1 <= leaf <= MAX_LEAF_LOG:
            raise ValueError(f"fused NTT leaf 2^{leaf}: the leaf kernel takes 2^1 .. 2^{MAX_LEAF_LOG}")
        self.spec = spec
        self.log_n = log_n
        self.inverse = inverse
        base = get_domain(spec, log_n, inverse)
        self.omega = base.omega
        self.n_inv = base.n_inv if inverse else None
        self.leaf = leaf
        self.plan = self._plan(log_n, leaf)
        self.leaf_tw: dict[int, np.ndarray] = {}
        self.inter: dict[tuple[int, int], np.ndarray] = {}
        self._build_tables()

    @staticmethod
    def _plan(log_n: int, leaf: int) -> list[int]:
        """Leaf-sized factors, the first ones full (20, leaf 8 -> [8, 8, 4])."""
        out = []
        rest = log_n
        while rest > leaf:
            out.append(leaf)
            rest -= leaf
        out.append(rest)
        return out

    def _leaf_tables(self, log_m: int) -> np.ndarray:
        """(log_m, m/2, L) DIF stage twiddles of the size-m leaf: stage s's
        butterfly at position p multiplies by W_m^((p mod m/2^(s+1)) 2^s)."""
        m = 1 << log_m
        w_m = pow(self.omega, 1 << (self.log_n - log_m), self.spec.modulus)
        master = twiddle_table_np(self.spec, w_m, max(0, log_m - 1))  # (m/2, L)
        idx = np.arange(m // 2)
        return np.stack([master[(idx % (m >> (s + 1))) << s] for s in range(log_m)])

    def _build_tables(self):
        log_rest = self.log_n
        for leaf in self.plan:
            if leaf not in self.leaf_tw and leaf > 0:
                self.leaf_tw[leaf] = self._leaf_tables(leaf)
            if leaf == log_rest:
                break
            n1_log = log_rest - leaf
            self.inter[(log_rest, n1_log)] = cached_table(
                self.spec, "fusedinter", (self.log_n, int(self.inverse), log_rest, n1_log),
                lambda lr=log_rest, nl=n1_log: inter_table_np(
                    self.spec, self.omega, self.log_n, lr, nl
                ),
            )
            log_rest = n1_log


@functools.lru_cache(maxsize=32)
def _fused_domain(spec: FieldSpec, log_n: int, inverse: bool, leaf: int) -> FusedDomain:
    with phase("build/fused_domain"):
        return FusedDomain(spec, log_n, inverse, leaf)


def get_fused_domain(spec: FieldSpec, log_n: int, inverse: bool = False) -> FusedDomain:
    """The domain at the configured leaf (``ntt_leaf_log``)."""
    return _fused_domain(spec, log_n, inverse, get_config().ntt_leaf_log)


def fused_consts(dom: FusedDomain, device) -> dict:
    """The domain's tables as tensors on ``device``, in the storage dtype."""
    dt = storage_dtype(device)

    def limbs(a):
        return torch.as_tensor(np.asarray(a, np.int64), device=device).to(dt)

    return {
        "leaf": {k: limbs(v) for k, v in dom.leaf_tw.items()},
        "inter": {k: limbs(v) for k, v in dom.inter.items()},
    }


def _rec(F: FieldOps, dom: FusedDomain, x: torch.Tensor, log_m: int, consts: dict):
    """Natural-in, natural-out NTT of size 2^log_m along axis 0 of (m, B, L)."""
    if log_m <= dom.leaf:
        return ntt_leaf(F.spec, x, consts["leaf"][log_m]) if log_m else x
    _, B, L = x.shape
    log_n1 = log_m - dom.leaf
    n1, n2 = 1 << log_n1, 1 << dom.leaf
    T = consts["inter"][(log_m, log_n1)]  # (n2, n1, L)
    # steps 1-3 in one launch: (n1, n2 * B, L), row j1 = (k2, b) twiddled
    y = ntt_leaf(F.spec, x.reshape(n2, n1 * B, L), consts["leaf"][dom.leaf], level=(T, B))
    z = _rec(F, dom, y, log_n1, consts)
    return z.reshape(n1 * n2, B, L)


def fused_ntt(F: FieldOps, dom: FusedDomain, x: torch.Tensor, consts: dict) -> torch.Tensor:
    """Natural-order NTT of an (n, L) Montgomery batch, bit-exact with the
    Pease and digit routes; the inverse scales by n^-1 with kernel K1."""
    y = _rec(F, dom, x.reshape(x.shape[0], 1, x.shape[1]), dom.log_n, consts)
    y = y.reshape(x.shape)
    return F.mul(y, F.constant(dom.n_inv)) if dom.inverse else y
