"""Cells on several ranks, one process a device, on the CPU through gloo:
a four-rank cell added as files runs in lock step and comes out correct; a
wrong answer on one rank makes the run not correct; a raise on one rank
ends the run with no result and no process left; a one-card cell spawns
nothing.  On the cards, the same all-reduce cell over NCCL."""

import json
import multiprocessing
import os
import shutil
import subprocess
import sys
import time

import pytest
import torch
import torch.distributed as dist

from benchmark import run as R
from benchmark.tests.test_bench_harness import SPEC, TINY, keeps_the_contract

CELL = "tiny-allreduce"
#: rank 0 of a multi-rank run, in a fresh interpreter: argv[1] the
#: checkout's root, argv[2] the run's arguments as JSON
RANK0 = (
    "import importlib, json, sys\n"
    "sys.path.insert(0, sys.argv[1])\n"
    "import torch\n"
    "torch.set_num_threads(1)\n"
    "from benchmark import run as R\n"
    "a = json.loads(sys.argv[2])\n"
    "cell = R.Cell(a['cell'], R.benchmark_spec(), a.get('traffic'))\n"
    "op = a.get('op') and getattr(importlib.import_module('benchmark.tests.rank_ops'), a['op'])\n"
    "sys.exit(R.report(*R.run(cell, a['seed'], a['seconds'], a['trace'], a['device'], op)))\n"
)


def add_allreduce_cell(root, chips, size=256):
    """Copy the benchmark under ``root`` and add, as new files and entries
    only, a configuration, a traffic of ``size`` elements an op, an op (the
    all-reduce of rank_ops.py) with its roofline, and the cell
    ``tiny-allreduce`` on ``chips`` ranks."""
    shutil.copytree(R.BENCH, root / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in map(str, (root / "benchmark").rglob("*")) if os.path.isfile(p)}
    spec = json.loads(json.dumps(SPEC))
    (root / "benchmark/configs/tiny-ranks.json").write_text(json.dumps({"name": "tiny-ranks"}))
    (root / "benchmark/workloads/tiny-allreduce.json").write_text(json.dumps(
        {"config": "tiny-ranks", "op": "allreduce", "size": size, "pool": 2, "warmup": 1, "check_sample": 1,
         "trace_ops": 2}))
    (root / "benchmark/ops/allreduce.py").write_text("from benchmark.tests.rank_ops import AllReduceOp as Op  # noqa: F401\n")
    (root / "benchmark/roofline/allreduce.py").write_text(
        "from benchmark.peaks import least\n\n\ndef work(config, traffic):\n"
        "    return least({}, 2 * 8 * traffic['size'])\n")
    spec["configs"].append({"name": "tiny-ranks", "source": "https://example.org/tiny", "reduced": [],
                            "file": "benchmark/configs/tiny-ranks.json", "why": "a test"})
    spec["workloads"].append({"name": CELL, "config": "tiny-ranks", "traffic": "tiny-allreduce",
                              "chips": chips, "why": "a test"})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    if chips in (1, 4):
        keeps_the_contract(spec, str(root))
    return before


def rank0(root, device="cpu", op=None, seconds=0.3, trace=False, **traffic):
    """Run the cell from ``root`` as rank 0 in a fresh interpreter:
    (exit code, standard output, standard error, seconds taken)."""
    args = {"cell": CELL, "seed": 2**31 + 101, "seconds": seconds, "device": device, "op": op, "trace": trace,
            "traffic": traffic or None}
    # the program from this checkout, the benchmark from the copy; TMPDIR in the copy
    env = {**os.environ, "PYTHONPATH": R.ROOT, "TMPDIR": str(root / "tmp")}
    os.makedirs(root / "tmp", exist_ok=True)
    t = time.monotonic()
    out = subprocess.run([sys.executable, "-c", RANK0, str(root), json.dumps(args)], capture_output=True,
                         text=True, timeout=120, cwd=root, env=env)
    return out.returncode, out.stdout, out.stderr, time.monotonic() - t


def gone(pid: int) -> bool:
    try:
        os.kill(pid, 0)
    except ProcessLookupError:
        return True
    with open(f"/proc/{pid}/stat") as f:  # a zombie not reaped yet has ended too
        return f.read().rsplit(")", 1)[1].split()[0] == "Z"


def test_a_four_rank_cell_added_as_files_runs_in_lock_step(tmp_path):
    before = add_allreduce_cell(tmp_path, 4)
    rc, out, err, _ = rank0(tmp_path, size=256, pool=2, warmup=1, pid_dir=str(tmp_path))
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    dev = line["device"]
    assert line["correct"] and line["failed"] == 0 and line["attempted"] >= 1, line
    assert dev["count"] == 4 and [r["rank"] for r in dev["ranks"]] == [0, 1, 2, 3]
    assert {r["attempted"] for r in dev["ranks"]} == {line["attempted"]}
    assert dev["memory_peak_bytes"] == max(r["memory_peak_bytes"] for r in dev["ranks"])
    assert sorted(line["checks"]) == [f"r{k}/elements_wrong" for k in range(4)]
    assert list(line)[-1] == "checks" and "check r3/elements_wrong: 0 (limit 0)" in err
    pids = [int(open(tmp_path / f"rank{k}.pid").read()) for k in range(4)]
    assert len(set(pids)) == 4 and all(gone(p) for p in pids[1:])
    assert all(open(p, "rb").read() == b for p, b in before.items())
    assert os.listdir(tmp_path / "tmp") == []  # the store's directory, removed


def test_a_wrong_answer_on_one_rank_is_not_correct(tmp_path):
    add_allreduce_cell(tmp_path, 4)
    rc, out, err, _ = rank0(tmp_path, op="WrongOnRank1")
    assert rc == 0, err[-3000:]
    line = json.loads(out.strip().splitlines()[-1])
    assert not line["correct"]
    over = {k for k, c in line["checks"].items() if c["value"] > c["limit"]}
    assert over == {"r1/elements_wrong"}, line["checks"]


@pytest.mark.parametrize("rank,why", [(2, "rank 2 exited with code 1"), (0, "rank 0 raised; ending every rank")])
def test_a_raise_on_one_rank_ends_the_run(tmp_path, rank, why):
    """A rank raises while the others wait for it in the all-reduce: rank 0
    ends every rank, reaps them and exits with no result."""
    add_allreduce_cell(tmp_path, 4)
    rc, out, err, _ = rank0(tmp_path, op=f"RaisesOnRank{rank}", seconds=20, size=256, pool=2, warmup=1,
                            pid_dir=str(tmp_path))
    ended = time.time()
    assert rc == R.RANK_FAULT_EXIT and out == "", (rc, out, err[-3000:])
    assert f"planted: rank {rank} raises on its third op" in err and why in err
    assert "every rank ended, no result" in err
    assert ended - float(open(tmp_path / "raised").read()) < 30
    pids = [int(open(tmp_path / f"rank{k}.pid").read()) for k in range(4)]
    deadline = time.monotonic() + 10
    while not all(gone(p) for p in pids) and time.monotonic() < deadline:
        time.sleep(0.2)
    assert all(gone(p) for p in pids)
    assert os.listdir(tmp_path / "tmp") == []  # the store's directory, removed


def test_a_forbidden_module_that_a_metric_reader_loads_on_rank_0_gives_no_result(tmp_path):
    """The import check comes after the result line is made: a metric reader
    (loaded by rank 0 alone, after the ranks have ended) that loads the JAX
    package ends the run with no result."""
    add_allreduce_cell(tmp_path, 4)
    (tmp_path / "benchmark/metrics/planted_import.py").write_text(
        "import sys\nimport types\n\n\ndef read(run):\n"
        "    sys.modules.setdefault('tpu_ec', types.ModuleType('tpu_ec'))\n    return 1.0\n")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    spec["end_to_end"].append({"name": "planted_import", "unit": "ms", "better": "lower", "bound": 0.01,
                               "source": "host_clock", "workloads": [CELL]})
    keeps_the_contract(spec, str(tmp_path))
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    rc, out, err, _ = rank0(tmp_path)
    assert rc == 4 and out == "", (rc, out, err[-3000:])
    assert "the process holds tpu_ec; no result" in err


def test_the_control_reads_every_rank(tmp_path):
    """benchmark/control.py on four ranks: rank 0 prints each seed's line,
    every rank's numbers under r<k>/; the program's read 0, the control's not."""
    add_allreduce_cell(tmp_path, 4)
    code = ("import sys; sys.path.insert(0, sys.argv[1])\n"
            "from benchmark import control, run as R\n"
            "control.rank_readings(R.Cell('tiny-allreduce', R.benchmark_spec()), [7, 2**31 + 9], 0.2, 'cpu')\n")
    out = subprocess.run([sys.executable, "-c", code, str(tmp_path)], capture_output=True, text=True, timeout=120,
                         cwd=tmp_path, env={**os.environ, "PYTHONPATH": R.ROOT, "TMPDIR": str(tmp_path)})
    assert out.returncode == 0, out.stderr[-3000:]
    lines = [json.loads(x) for x in out.stdout.strip().splitlines()]
    assert [x["seed"] for x in lines] == [7, 2**31 + 9]
    for x in lines:
        assert x["program"] == {f"r{k}/elements_wrong": 0 for k in range(4)}
        assert sorted(x["control"]) == sorted(x["program"]) and all(v > 0 for v in x["control"].values())


def test_a_one_card_cell_spawns_nothing(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a one-card cell spawned a process")

    monkeypatch.setattr(multiprocessing.process.BaseProcess, "start", refuse)
    monkeypatch.setattr(dist, "init_process_group", refuse)
    cell = R.Cell("ecfft-16x2p11", SPEC, TINY["ec_fft"])
    line, checks, found = R.run(cell, 2**31 + 13, 0.05, False, "cpu")
    assert line["correct"] and line["device"]["count"] == 1 and "ranks" not in line["device"], checks
    assert [c[0] for c in checks] == ["points_wrong"] and "tpu_ec" not in found
    assert not dist.is_initialized() and multiprocessing.active_children() == []


def test_a_result_line_takes_the_largest_peak_and_every_rank_s_checks():
    """``result_line`` over hand-made parts: the largest peak, count 4, and
    correct only when every rank compared something within its limit."""
    run = R.Run(R.Cell("ecfft-16x2p11", SPEC), False)
    run.latencies_s, run.window_s, run.setup_s = [0.1, 0.1], 0.2, 1.0
    parts = [{"rank": k, "attempted": 2, "memory_peak_bytes": 10 + 7 * (k == 2), "checks": [("w", 0, 0)]}
             for k in range(4)]
    checks = [(f"r{p['rank']}/w", 0, 0) for p in parts]
    line = R.result_line(run, checks, torch.device("cpu"), parts)
    assert line["correct"] and line["device"]["count"] == 4 and line["device"]["memory_peak_bytes"] == 17
    assert line["metrics"]["peak_gib"]["value"] == 17 / 2**30
    parts[3]["checks"] = []
    assert not R.result_line(run, checks[:3], torch.device("cpu"), parts)["correct"]


@pytest.fixture
def cards(request):
    """The number of cards the test asks for, or a skip where there are fewer."""
    if not torch.cuda.is_available() or torch.cuda.device_count() < request.param:
        pytest.skip(f"needs {request.param} CUDA cards")
    return request.param


@pytest.mark.cuda
@pytest.mark.parametrize("cards", [2, 4], indirect=True)
def test_an_nccl_all_reduce_cell_on_the_cards(cards, tmp_path):
    """The benchmark's own command, ``python3 benchmark/run.py --workload ...``,
    from a checkout that holds the benchmark with the cell added and the
    program: ``main`` spawns the ranks from run.py as the main module."""
    add_allreduce_cell(tmp_path, cards, size=1 << 20)
    os.symlink(os.path.join(R.ROOT, "tpu_ec_torch"), tmp_path / "tpu_ec_torch")  # one kernel build
    os.makedirs(tmp_path / "tmp")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    for trace in (0, 1):
        t = time.monotonic()
        out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", CELL, "--seed", str(2**31 + 77),
                              "--seconds", "2", "--trace", str(trace)], capture_output=True, text=True,
                             timeout=600, cwd=tmp_path, env={**env, "TMPDIR": str(tmp_path / "tmp")})
        took = time.monotonic() - t
        assert out.returncode == 0, out.stderr[-3000:]
        line = json.loads(out.stdout.strip().splitlines()[-1])
        assert line["correct"] and line["attempted"] >= 10, line
        assert sorted(line["checks"]) == [f"r{k}/elements_wrong" for k in range(cards)]
        dev = line["device"]
        assert dev["platform"] == "gpu" and dev["count"] == cards and len(dev["ranks"]) == cards
        assert all(r["memory_peak_bytes"] > 0 for r in dev["ranks"])
        assert {r["attempted"] for r in dev["ranks"]} == {line["attempted"]}
        if trace:
            assert dev["busy_s"] > 0 and all(r["busy_s"] > 0 for r in dev["ranks"])
            assert "device_idle_pct" in line["metrics"]
        else:
            assert set(line["metrics"]) == {"op_ms", "peak_gib", "setup_s"}
        left = sorted(os.listdir(tmp_path / "tmp"))  # torch may leave its own cache directory there
        assert not [d for d in left if d.startswith("bench-ranks-")], left  # the store's, removed
        print(f"world {cards}, trace {trace}: {line['attempted']} all-reduces of 8 MiB in 2 s, "
              f"{json.dumps(line['metrics'])}, device {json.dumps(dev)}, run {took:.1f} s, TMPDIR holds {left}")
