"""The port's host utils and public names: the worker pool, the phase timer,
the config knobs of the distributed layer, the cached field and point
factories and ``PointOps.generator_affine`` (against tpu_ec's limbs)."""

import threading

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import numpy as np

from tpu_ec.curves import oracle
from tpu_ec.curves import params as jcp
from tpu_ec.curves.point import point_ops as j_point_ops
from tpu_ec_torch import curves, fields
from tpu_ec_torch.config import Config, get_config
from tpu_ec_torch.errors import DeviceError
from tpu_ec_torch.ops import msm as tmsm
from tpu_ec_torch.ops import msm_scan as tscan
from tpu_ec_torch.ops.msm import MultiexpKernel
from tpu_ec_torch.utils import threadpool, timer


@pytest.fixture
def num_threads():
    cfg = get_config()
    saved = cfg.num_threads
    yield cfg
    cfg.num_threads = saved


def test_worker_compute_and_waiter():
    w = threadpool.Worker()
    a = w.compute(lambda x, y=0: x * 3 + y, 5, y=1)
    assert a.wait() == 16 and a.done()
    other = w.compute(threading.get_ident)
    assert other.wait() != threading.get_ident()  # ran on a pool thread
    bad = w.compute(lambda: 1 / 0)
    with pytest.raises(ZeroDivisionError):
        bad.wait()


@pytest.mark.parametrize("threads,elements,chunks", [(3, 10, [(0, 4), (4, 4), (8, 2)]), (4, 2, [(0, 1), (1, 1)]),
                                                     (2, 0, [])])
def test_worker_scope_chunks(num_threads, threads, elements, chunks):
    """One chunk a thread, in order, covering [0, elements)."""
    num_threads.num_threads = threads
    assert threadpool.Worker().scope(elements, lambda start, length: (start, length)) == chunks


@pytest.mark.parametrize("threads,log", [(1, 0), (4, 2), (5, 2), (8, 3)])
def test_log_num_threads(num_threads, threads, log):
    num_threads.num_threads = threads
    assert threadpool.pool_size() == threads
    assert threadpool.Worker.log_num_threads() == log


@pytest.fixture
def timing():
    timer.STATS.reset()
    was = timer.enabled()
    yield
    timer.enable(was)
    timer.STATS.reset()


def test_timer_phases(timing):
    timer.enable(False)
    with timer.phase("off"):
        pass
    assert dict(timer.STATS.records) == {}
    timer.enable()
    with timer.phase("a"):
        with timer.phase("b"):
            pass
        with timer.phase("b"):
            pass
    summary = timer.STATS.summary()
    assert sorted(summary) == ["a", "a/b"]
    assert summary["a/b"]["count"] == 2 and summary["a"]["total_s"] >= summary["a/b"]["total_s"]
    lines = timer.report().splitlines()
    assert lines[0].startswith("a: n=1 total=") and lines[1].startswith("a/b: n=2 total=")


def test_timer_msm_phases(timing, monkeypatch):
    """multiexp records its entry span "msm", around the input marshalling
    and the engine's call, for the engines and the lattice alike (the
    engines stubbed: the spans are the test); the old "msm/prepare" and
    "msm/dispatch" phases are gone."""
    monkeypatch.setattr(tmsm, "msm_lattice", lambda *a, **kw: "lattice")
    monkeypatch.setattr(tscan, "msm_scan", lambda *a, **kw: "scan")
    timer.enable()
    kern = MultiexpKernel(curves.BN254_G1, "cpu")
    ops = kern.ops
    pts = ops.from_affine_ints(oracle.random_points(jcp.BN254_G1, 2, seed=1))
    s = ops.scalars_to_limbs([3, 5])
    assert kern.multiexp(pts, s, method="scan", window_size=8) == "scan"
    assert kern.multiexp(pts, s, signed=False, window_size=8) == "lattice"
    summary = timer.STATS.summary()
    assert summary["msm"]["count"] == 2 and summary["msm"]["device_ms"] is None
    assert "msm/prepare" not in summary and "msm/dispatch" not in summary


def test_config_env(monkeypatch):
    for k, v in (("TPU_EC_TORCH_NUM_THREADS", "3"), ("TPU_EC_TORCH_TIMER", "1"), ("TPU_EC_TORCH_MIN_DEVICES", "2"),
                 ("TPU_EC_TORCH_DIST_MSM_ACCUM", "scan")):
        monkeypatch.setenv(k, v)
    cfg = Config.from_env()
    assert (cfg.num_threads, cfg.timer, cfg.min_devices, cfg.dist_msm_accum) == (3, True, 2, "scan")
    for k in ("TPU_EC_TORCH_NUM_THREADS", "TPU_EC_TORCH_TIMER", "TPU_EC_TORCH_MIN_DEVICES",
              "TPU_EC_TORCH_DIST_MSM_ACCUM"):
        monkeypatch.delenv(k)
    cfg = Config.from_env()
    assert (cfg.num_threads, cfg.timer, cfg.min_devices, cfg.dist_msm_accum) == (0, False, 1, "pair")


def test_cached_factories():
    """One ops object a spec and device, whatever names the device; the
    factories are exported beside the classes."""
    fr = fields.BLS12_381_FR
    assert fields.field_ops(fr, "cpu") is fields.field_ops(fr, torch.device("cpu"))
    assert fields.field_ops(fr, "cpu") is not fields.field_ops(fields.BN254_FR, "cpu")
    assert isinstance(fields.field_ops(fr, "cpu"), fields.FieldOps)
    assert fields.fp2_ops(fields.BN254_FQ, "cpu") is fields.fp2_ops(fields.BN254_FQ, "cpu")
    assert isinstance(fields.fp2_ops(fields.BN254_FQ, "cpu"), fields.Fp2Ops)
    for spec in curves.ALL_CURVES:
        assert curves.point_ops(spec, "cpu") is curves.point_ops(spec, torch.device("cpu"))
        assert curves.point_ops(spec, "cpu").spec is spec
    if not torch.cuda.is_available():
        with pytest.raises(DeviceError):
            curves.point_ops(curves.BN254_G1)


@pytest.mark.parametrize("name", ["BN254_G1", "BLS12_381_G1", "BN254_G2", "BLS12_381_G2"])
def test_generator_affine(name):
    """The generator's (x, y), batch shape (), equal to tpu_ec's limbs (G2:
    its (c0, c1) pair side by side), on the curve, cached."""
    ops = curves.point_ops(getattr(curves, name), "cpu")
    jops = j_point_ops(getattr(jcp, name))
    x, y = ops.generator_affine
    assert x.shape == y.shape == (ops.width,)
    assert ops.generator_affine is ops.generator_affine
    for got, want in zip((x, y), jops.generator_affine):
        if isinstance(want, tuple):
            want = np.concatenate([np.asarray(c) for c in want], axis=-1)
        assert np.array_equal(got.numpy(), np.asarray(want).astype(np.int64))
    spec = ops.spec
    assert ops.to_affine_ints((x[None], y[None])) == [(spec.gen_x, spec.gen_y)]
