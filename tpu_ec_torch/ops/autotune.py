"""Measured MSM window table: the best window per curve, engine and size.

PyTorch counterpart of ``tpu_ec/ops/autotune.py``, over a table of the
card's own: ``tuned_windows.json`` beside this module, written by
``tpu_ec_torch/utils/autotune_msm.py`` on an H100 (no row of tpu_ec's TPU
table carries over).  The table is {curve: {engine: {log2 n: window}}};
its top-level ``"_card"`` names the card and power limit it was measured
on, and the lookup ignores it.  ``MultiexpKernel`` consults it after the
argument (and, for one MSM, ``config.msm_window``) and before the
engine's model.
"""

from __future__ import annotations

import functools
import json
import os

from ..utils.timer import phase

_TABLE_PATH = os.path.join(os.path.dirname(__file__), "tuned_windows.json")


@functools.lru_cache(maxsize=1)
def _table() -> dict:
    """The table on disk; a missing file is an empty table."""
    with phase("build/window_table"):
        if not os.path.exists(_TABLE_PATH):
            return {}
        with open(_TABLE_PATH) as fh:
            return json.load(fh)


def tuned_window(curve_name: str, engine: str, n: int) -> int | None:
    """Measured best window for ~n points on this curve and engine, or None.

    Keyed by engine, since the engines' costs differ in shape (the scan
    engine does ~log2(n) adds a point and window, the pair engine ~1).  The
    nearest measured log2 size (the smaller of two as near) counts only
    within 2 of n's."""
    by_log = (_table().get(curve_name) or {}).get(engine)
    if not by_log:
        return None
    log_n = max(1, n.bit_length() - 1)
    nearest = min(sorted(int(k) for k in by_log), key=lambda k: abs(k - log_n))
    if abs(nearest - log_n) > 2:
        return None
    return int(by_log[str(nearest)])
