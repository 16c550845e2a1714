"""The port's distributed NTT and mesh on gloo ranks, against tpu_ec.

One spawn of ranks a world size (d = 2 and d = 4, module-scoped,
``tests/torch_dist_ranks.py``, from a FileStore in a temporary directory)
runs every case while this process computes the references; the ranks
write their slabs and twiddle slices as .npy files and this process holds
them bit for bit against tpu_ec's
``DistFftKernel`` on a virtual mesh of four devices (conftest's 8 CPU
devices) and against the single-card port.  tpu_ec's output is the
canonical transform whatever its mesh size (tests/test_parallel.py holds it
against the single-device NTT), so both world sizes are held against the
one mesh's output: one XLA-CPU compile a case instead of two, which keeps
the suite inside its time limit on a cold JAX cache.  The Pease route runs at 2^6,
2^10 and 2^14 (the dry run's size), the digit route at 2^8 with
``ntt_digit_leaf_log`` = 4 and the route forced (``use_digit_local``),
both directions; tpu_ec runs its CPU route (Pease local stages), whose
canonical values every route shares.  Inputs come from numpy seeds; tolerance: none (integers).
"""

import functools
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
torch.set_num_threads(1)  # the suite runs in several worker processes

import jax
import jax.numpy as jnp
import numpy as np

import torch_dist_ranks as ranks
from tpu_ec.fields import BLS12_381_FR as J_FR
from tpu_ec.parallel import DistFftKernel as JDistFft
from tpu_ec.parallel import make_mesh as j_make_mesh
from tpu_ec.parallel.ntt_dist import _get_dist_domain
from tpu_ec_torch.errors import DeviceError
from tpu_ec_torch.fields import BLS12_381_FR, FieldOps
from tpu_ec_torch.ops.ntt import FftKernel
from tpu_ec_torch.parallel import make_mesh, run_spmd

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PEASE = [6, 10, 14]
DIGIT = 8
SINGLE_MAX = 14  # sizes held against the single-card port too
REF_D = 4  # the mesh size of tpu_ec's references
NTT_CASES = [(log_n, inv, "pease") for log_n in PEASE for inv in (False, True)] + \
    [(DIGIT, inv, "digit") for inv in (False, True)]
# make_mesh's policy on four ranks: (ranks failing the probe, want, min_devices)
MESH_CASES = [((3,), 4, 1), ((3,), 4, 4), ((0, 1, 2, 3), None, 1), ((), 2, 1)]


def _inputs(log_n: int) -> np.ndarray:
    """2^log_n random canonical Fr elements, Montgomery, (n, 16) int64."""
    rng = np.random.default_rng(1000 + log_n)
    vals = [int.from_bytes(rng.bytes(32), "little") % BLS12_381_FR.modulus for _ in range(1 << log_n)]
    return FieldOps(BLS12_381_FR, "cpu").from_ints(vals).numpy()


@functools.lru_cache(maxsize=None)
def _j_kernel(d: int) -> JDistFft:
    return JDistFft(J_FR, j_make_mesh(jax.devices()[:d]))


def _tpu_ec_dist(x: np.ndarray, d: int, inverse: bool) -> np.ndarray:
    """tpu_ec's distributed NTT on a d-device virtual mesh, on its CPU route
    (Pease local stages: every route gives the same canonical values)."""
    return np.asarray(jax.device_get(_j_kernel(d).radix_fft(jnp.asarray(x.astype(np.uint32)), inverse=inverse)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The spawns of both world sizes, and the references computed while
    they run: "work" {d: directory}, "want" {(log_n, inverse): tpu_ec's
    output on REF_D devices}, "single" {(log_n, inverse): the single-card port's},
    "tw" {(d, log_n, inverse): tpu_ec's whole twiddle table}."""
    inputs = {log_n: _inputs(log_n) for log_n in PEASE + [DIGIT]}
    runs, work = [], {}
    for d in (2, 4):
        work[d] = str(tmp_path_factory.mktemp(f"ntt_d{d}"))
        for log_n, x in inputs.items():
            np.save(os.path.join(work[d], f"ntt_{BLS12_381_FR.name}_{log_n}.npy"), x)
        cases = [(BLS12_381_FR.name, *c) for c in NTT_CASES]
        runs.append((d, (work[d], cases, [], False, MESH_CASES if d == 4 else [])))
    spawn = ranks.Spawn(runs)
    want = {(log_n, inv): _tpu_ec_dist(inputs[log_n], REF_D, inv) for log_n, inv, _ in NTT_CASES}
    single = {(log_n, inv): FftKernel(BLS12_381_FR, "cpu").radix_fft(torch.as_tensor(inputs[log_n]), inv).numpy()
              for log_n, inv, _ in NTT_CASES if log_n < SINGLE_MAX}
    tw = {(d, log_n, inv): np.asarray(jax.device_get(
        _get_dist_domain(J_FR, log_n, j_make_mesh(jax.devices()[:d]), inv).twiddles)).astype(np.int64)
        for d in (2, 4) for log_n in PEASE + [DIGIT] for inv in (False, True)}
    spawn.join()
    return {"work": work, "inputs": inputs, "want": want, "single": single, "tw": tw}


def _gathered(work: str, name: str, d: int) -> np.ndarray:
    return np.concatenate([np.load(os.path.join(work, f"{name}_r{r}.npy")) for r in range(d)])


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("log_n,inverse,route", NTT_CASES)
def test_dist_ntt(runs, d, log_n, inverse, route):
    """Each rank's slab, concatenated, equals tpu_ec's DistFftKernel (on
    REF_D devices: the same canonical values at any mesh size) and (below
    2^14, whose plain single-card transform takes seconds a direction) the
    single-card port's transform."""
    got = _gathered(runs["work"][d], ranks.ntt_case_name(log_n, inverse, route), d)
    assert got.shape == runs["inputs"][log_n].shape
    assert np.array_equal(got, runs["want"][log_n, inverse].astype(np.int64))
    if log_n < SINGLE_MAX:
        assert np.array_equal(got, runs["single"][log_n, inverse])


@pytest.mark.parametrize("d", [2, 4])
@pytest.mark.parametrize("log_n", PEASE + [DIGIT])
@pytest.mark.parametrize("inverse", [False, True])
def test_twiddle_slice(runs, d, log_n, inverse):
    """Rank r's twiddle slice, built with K1's plain version, equals columns
    [r n2/d, (r + 1) n2/d) of tpu_ec's host-built DistDomain.twiddles."""
    table = runs["tw"][d, log_n, inverse]
    cols = table.shape[1] // d
    for r in range(d):
        got = np.load(os.path.join(runs["work"][d], f"tw_{log_n}_{int(inverse)}_r{r}.npy"))
        assert np.array_equal(got, table[:, r * cols : (r + 1) * cols])


@pytest.mark.parametrize("k", range(len(MESH_CASES)))
def test_make_mesh_policy(runs, k):
    """Degraded startup on four ranks: one rank failing the probe leaves the
    largest power-of-two subset (ranks 0 and 1, a working group), unless
    min_devices forbids it; no working rank raises; want=2 takes ranks 0-1."""
    got = []
    for r in range(4):
        with open(os.path.join(runs["work"][4], f"mesh_{k}_r{r}.json")) as fh:
            got.append(json.load(fh))
    if k in (0, 3):
        assert got[:2] == [{"mesh": [2, 0], "members": 3}, {"mesh": [2, 1], "members": 3}]
        assert got[2:] == [{"mesh": None}, {"mesh": None}]
    elif k == 1:
        assert all("min_devices=4" in g["error"] for g in got)
    else:
        assert all("no working device" in g["error"] for g in got)


def test_no_process_group_or_card_raises():
    """Without torch.distributed started, make_mesh raises DeviceError; so do
    the spawned path and the dry run on "cuda" without enough cards, before
    any spawn."""
    from tpu_ec_torch.entry import dryrun_multichip

    with pytest.raises(DeviceError, match="not initialised"):
        make_mesh()
    if torch.cuda.device_count() < 2:
        with pytest.raises(DeviceError, match="CUDA devices"):
            run_spmd(print, 2)
        with pytest.raises(DeviceError, match="CUDA devices"):
            dryrun_multichip(2)


BACKENDS = [  # (dist.get_backend_config, cuda available, device type or the DeviceError's text)
    ("cuda:nccl", True, "cuda"),
    ("cpu:gloo,cuda:nccl", True, "cuda"),  # init_process_group() with no backend on a card
    ("cpu:gloo,cuda:gloo", True, "cpu"),  # "gloo"
    ("cpu:gloo", False, "cpu"),  # no backend on a machine without a card
    ("cuda:nccl", False, "needs a CUDA device"),
    ("cpu:gloo,cuda:nccl", False, "needs a CUDA device"),
    ("cpu:nccl,cuda:gloo", True, "not the CUDA backend"),
    ("cpu:mpi,cuda:mpi", True, "NCCL \\(card\\) or gloo \\(CPU\\) only"),
    ("cpu:gloo,cuda:ucc", True, "NCCL \\(card\\) or gloo \\(CPU\\) only"),
]


@pytest.mark.parametrize("config,cuda,want", BACKENDS)
def test_backend_device_type(config, cuda, want):
    """A mesh's device follows its group's device-backend map: the card
    wherever NCCL is among the backends, the CPU for gloo alone, and a
    DeviceError for a missing card or a map it cannot read."""
    from tpu_ec_torch.parallel.mesh import backend_device_type

    if want in ("cuda", "cpu"):
        assert backend_device_type(config, cuda) == want
    else:
        with pytest.raises(DeviceError, match=want):
            backend_device_type(config, cuda)


def test_mesh_device_from_group(tmp_path, monkeypatch):
    """make_mesh in a one-rank group started with no backend named ("cpu:gloo"
    without a card) runs on the CPU; the same group reporting NCCL among its
    backends without a card raises DeviceError instead of falling back to
    the CPU."""
    import torch.distributed as dist

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    dist.init_process_group(store=dist.FileStore(str(tmp_path / "store"), 1), rank=0, world_size=1)
    try:
        assert make_mesh().device == torch.device("cpu")
        monkeypatch.setattr(dist, "get_backend_config", lambda group=None: "cpu:gloo,cuda:nccl")
        with pytest.raises(DeviceError, match="needs a CUDA device"):
            make_mesh()
    finally:
        dist.destroy_process_group()


def test_dryrun_multichip_cpu():
    """The dry run on four gloo ranks: the 2^14 NTT against the bigint NTT,
    the 2^10 MSM against the native Pippenger."""
    from tpu_ec_torch.entry import dryrun_multichip

    dryrun_multichip(4, device="cpu")


def test_parallel_imports_without_jax():
    code = ("import sys, tpu_ec_torch.parallel, tpu_ec_torch.entry\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'tpu_ec'))\n"
            "assert not bad, bad\nprint('ok')\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=dict(os.environ, PYTHONPATH=REPO),
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr[-3000:]
    assert res.stdout.strip() == "ok"
