"""The port's MSM window table (``tpu_ec_torch/ops/autotune.py``) against
tpu_ec's ``tuned_window``, the committed H100 table, and the order in which
``multiexp`` and ``multiple_multiexp`` take their window (the argument,
``config.msm_window`` for one MSM only, the table, the engine's model; as
``tpu_ec/ops/msm.py:423-428, 529-535``).  The engines are replaced by
stubs that record the window, so nothing here runs an MSM.
"""

import json

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

from tpu_ec.ops import autotune as jat
from tpu_ec_torch import curves
from tpu_ec_torch.config import get_config
from tpu_ec_torch.ops import autotune as tat
from tpu_ec_torch.ops import msm_pair, msm_scan
from tpu_ec_torch.ops.msm import MultiexpKernel

TABLE = {
    "_card": "a card, 700.00 W",
    "bls12_381_g1": {"pair": {"14": 10, "16": 11, "20": 14, "22": 16}, "scan": {"14": 11}},
    "bn254_g1": {"pair": {}},
    "bls12_381_g2": {"scan": {"16": 12, "20": 15}},
}


@pytest.fixture
def table(tmp_path, monkeypatch):
    """Both packages read one temporary table file."""
    path = tmp_path / "tuned_windows.json"
    path.write_text(json.dumps(TABLE))
    for mod in (jat, tat):
        monkeypatch.setattr(mod, "_TABLE_PATH", str(path))
        mod._table.cache_clear()
    yield path
    for mod in (jat, tat):
        mod._table.cache_clear()


def test_tuned_window_matches_tpu_ec(table):
    for curve in ("bls12_381_g1", "bls12_381_g2", "bn254_g1", "bn254_g2"):
        for engine in ("pair", "scan", "coz", "sorted"):
            for n in [0, 1, 2, 3] + [(1 << k) + d for k in range(2, 27) for d in (-1, 0, 1)]:
                assert tat.tuned_window(curve, engine, n) == jat.tuned_window(curve, engine, n), (curve, engine, n)
    assert tat.tuned_window("bls12_381_g1", "pair", 1 << 15) == 10  # the nearer of 14 and 16: the smaller
    assert tat.tuned_window("bls12_381_g1", "pair", 1 << 18) == 11  # 16 and 20 tie: 16
    assert tat.tuned_window("bls12_381_g1", "pair", 1 << 25) is None  # 3 from 22


def test_missing_table_is_empty(tmp_path, monkeypatch):
    monkeypatch.setattr(tat, "_TABLE_PATH", str(tmp_path / "none.json"))
    tat._table.cache_clear()
    try:
        assert tat._table() == {}
        assert tat.tuned_window("bls12_381_g1", "pair", 1 << 20) is None
    finally:
        tat._table.cache_clear()


def test_committed_table_is_the_cards():
    """The table in the package names an NVIDIA card and holds, by engine,
    the rows its tool measures: G1 pair at 2^14 .. 2^22, G1 scan at 2^14,
    G2 scan at 2^16 and 2^20."""
    tat._table.cache_clear()
    with open(tat._TABLE_PATH) as fh:
        tab = json.load(fh)
    assert "NVIDIA" in tab["_card"] and "W" in tab["_card"]
    assert sorted(tab["bls12_381_g1"]["pair"], key=int) == ["14", "16", "18", "20", "22"]
    assert sorted(tab["bls12_381_g1"]["scan"]) == ["14"]
    assert sorted(tab["bls12_381_g2"]["scan"], key=int) == ["16", "20"]
    for curve, engines in tab.items():
        if curve == "_card":
            continue
        for engine, rows in engines.items():
            assert engine in ("pair", "scan", "coz", "lattice")
            assert all(isinstance(w, int) and 1 <= w <= 20 for w in rows.values())
            assert all(tat.tuned_window(curve, engine, 1 << int(k)) == w for k, w in rows.items())


def _recorder(seen):
    def engine(ops, points, scalars, *, window_size):
        seen.append(window_size)
        lead = scalars.shape[:-2] if scalars.dim() == 3 else (1,)
        return tuple(torch.zeros(lead + (ops.width,), dtype=torch.int32) for _ in range(3))

    return engine


@pytest.mark.parametrize("curve,method,log_n,table_w", [("bls12_381_g1", "pair", 16, 11),
                                                        ("bls12_381_g2", "scan", 15, 12)])
def test_window_order(table, monkeypatch, curve, method, log_n, table_w):
    seen = []
    monkeypatch.setattr(msm_pair, "msm_pair", _recorder(seen))
    monkeypatch.setattr(msm_scan, "msm_scan", _recorder(seen))
    model = {"pair": msm_pair.default_window_size_pair, "scan": msm_scan.default_window_size_scan}[method]
    kern = MultiexpKernel(getattr(curves, curve.upper()), "cpu")
    n = 1 << log_n
    bases = tuple(torch.zeros((n, kern.ops.width), dtype=torch.int32) for _ in range(2))
    scal = torch.zeros((n, 16), dtype=torch.int32)
    cfg = get_config()
    monkeypatch.setattr(cfg, "msm_window", None)

    def window(call, *args, **kw):
        """The one window the engine ran with in this call (in every chunk
        or slab it ran)."""
        seen.clear()
        call(*args, method=method, **kw)
        assert len(set(seen)) == 1, seen
        return seen[0]

    small = tuple(c[:8] for c in bases)
    assert window(kern.multiexp, bases, scal, window_size=5) == 5  # the argument first
    assert window(kern.multiexp, bases, scal) == table_w  # then the table
    assert window(kern.multiexp, small, scal[:8]) == model(8)  # 2^3: no row within 2, the model
    monkeypatch.setattr(cfg, "msm_window", 7)
    assert window(kern.multiexp, bases, scal) == 7  # config before the table
    # the batch ignores config: the table at the chunk size, or the model
    chunk_w = tat.tuned_window(curve, method, n // 4)
    assert window(kern.multiple_multiexp, bases, scal, 4) == (chunk_w or model(n // 4))
    assert window(kern.multiple_multiexp, bases, scal, 4, window_size=6) == 6


def test_no_table_falls_to_the_model(tmp_path, monkeypatch):
    monkeypatch.setattr(tat, "_TABLE_PATH", str(tmp_path / "none.json"))
    tat._table.cache_clear()
    seen = []
    monkeypatch.setattr(msm_pair, "msm_pair", _recorder(seen))
    monkeypatch.setattr(get_config(), "msm_window", None)
    kern = MultiexpKernel(curves.BLS12_381_G1, "cpu")
    n = 1 << 12
    bases = tuple(torch.zeros((n, kern.ops.width), dtype=torch.int32) for _ in range(2))
    try:
        kern.multiexp(bases, torch.zeros((n, 16), dtype=torch.int32), method="pair")
        kern.multiple_multiexp(bases, torch.zeros((n, 16), dtype=torch.int32), 4, method="pair")
    finally:
        tat._table.cache_clear()
    assert seen == [msm_pair.default_window_size_pair(n), msm_pair.default_window_size_pair(n // 4)]
