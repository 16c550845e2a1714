"""The harness: BENCHMARK.json against the contract, cells, configurations
and metrics found by name and added as files, and the import checks."""

import ast
import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from benchmark import run as R

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = R.benchmark_spec()
# the tiny sizes at which the CPU runs a cell's traffic (the plain versions)
TINY = {"commit": {"log_n": 4, "pool": 2, "warmup": 1, "check_sample": 1, "trace_ops": 1},
        "ec_fft": {"log_n": 3, "transforms": 2, "pool": 2, "warmup": 1, "trace_ops": 1},
        "msm": {"log_n": 3, "pool": 2, "warmup": 1, "trace_ops": 1},
        "msm_batch": {"base_log_n": 4, "tile": 2, "chunks": 4, "pool": 2, "warmup": 1, "trace_ops": 1}}
#: keys of a configuration's file that say what it is or how it was cut, and
#: so are never a cut themselves
NOT_SCALE = {"name", "source", "reduced", "assumed", "guarantees"}
CELLS = {"commit": "commit-2p20", "ec_fft": "ecfft-16x2p11", "msm": "g2-msm-2p20", "msm_batch": "msm-batch-2p10x2p12"}


def one_line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def keeps_the_contract(spec, root=R.ROOT):
    """Assert that ``spec`` (BENCHMARK.json's content) keeps the contract."""
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
    assert spec["paths"] == ["benchmark"] and spec["command"] == ["python3", "benchmark/run.py"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    configs = {c["name"]: c for c in spec["configs"]}
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert NAME.match(c["name"]) and one_line(c["source"]) and one_line(c["why"])
        assert c["file"] == f"benchmark/configs/{c['name']}.json" and os.path.exists(os.path.join(root, c["file"]))
        # reduced: at most 16 scale keys of the configuration's file: a number
        # or a nested group that the file states, not its text or notes
        assert isinstance(c["reduced"], list) and len(c["reduced"]) <= 16
        assert len(set(c["reduced"])) == len(c["reduced"])
        stated = json.load(open(os.path.join(root, c["file"])))
        for k in c["reduced"]:
            assert isinstance(k, str) and NAME.match(k) and k in stated and k not in NOT_SCALE, k
            assert isinstance(stated[k], (int, float, dict, list)) and not isinstance(stated[k], bool), k
    used = set()
    for w in spec["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and one_line(w["why"])
        assert w["config"] in configs and w["chips"] in (1, 4)
        used.add(w["config"])
    # four-card cells: at most a quarter of the cells, rounded down, and one always may
    assert sum(w["chips"] == 4 for w in spec["workloads"]) <= max(1, len(spec["workloads"]) // 4)
    assert used == set(configs)
    assert len({(w["config"], w["traffic"]) for w in spec["workloads"]}) == len(spec["workloads"])
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names)) and "setup_s" in names
    for m in spec["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert 0.01 <= m["bound"] <= 0.25 and m["source"] in ("host_clock", "device_trace")
    for m in spec["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in spec["end_to_end"]} and one_line(m["layer"])
    for m in spec["end_to_end"] + spec["per_layer"]:
        assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
    for w in spec["workloads"]:  # setup_s, one other end-to-end metric, one per-layer metric
        e2e = [m["name"] for m in R.metrics_for(spec, w["name"], False)]
        assert "setup_s" in e2e and len(e2e) >= 2 and R.metrics_for(spec, w["name"], True)


def test_benchmark_json_keeps_the_contract():
    keeps_the_contract(SPEC)


def with_cells(spec, chips):
    """``spec`` and one more cell a number of ``chips``, each of an existing
    configuration and traffic under a new name."""
    out = json.loads(json.dumps(spec))
    base = spec["workloads"][0]
    for k, n in enumerate(chips):
        out["workloads"].append({**base, "name": f"extra-{k}", "traffic": f"extra-{k}", "chips": n})
    return out


@pytest.mark.parametrize("chips,ok", [((4,), True), ((2,), False), ((3,), False), ((4, 4), False),
                                      ((1, 1, 1, 4, 4), True), ((1, 1, 1, 4, 4, 4), False)],
                         ids=["one-4", "a-2", "a-3", "two-4-of-7", "two-4-of-10", "three-4-of-11"])
def test_the_contract_takes_chips_1_or_4_on_a_quarter_of_the_cells(chips, ok):
    spec = with_cells(SPEC, chips)
    if ok:
        keeps_the_contract(spec)
    else:
        with pytest.raises(AssertionError):
            keeps_the_contract(spec)


@pytest.mark.parametrize("reduced", [["transforms per op"], ["no_such_key"], ["log_n", "log_n"],
                                     ["a" * 65], "log_n", ["name"], ["source"], ["reduced"], ["assumed"],
                                     ["guarantees"], ["field"], ["deployment"]])
def test_the_contract_refuses_a_reduced_that_is_not_keys_of_the_file(reduced):
    """Each entry of ``reduced`` names a scale key that the configuration's
    file states (bls12_381-porep-ntt-2p27's, which has every kind of key)."""
    spec = json.loads(json.dumps(SPEC))
    c = next(c for c in spec["configs"] if c["name"] == "bls12_381-porep-ntt-2p27")
    c["reduced"] = ["partitions"]
    keeps_the_contract(spec)
    c["reduced"] = reduced
    with pytest.raises(AssertionError):
        keeps_the_contract(spec)


@pytest.mark.parametrize("cell", [w["name"] for w in SPEC["workloads"]])
def test_every_name_finds_its_files(cell):
    c = R.Cell(cell, SPEC)
    assert c.traffic["config"] == c.entry["config"] and c.config["name"] == c.entry["config"]
    assert hasattr(R.load_module("ops", c.traffic["op"]), "Op")
    assert callable(R.load_module("roofline", c.traffic["op"]).work)
    for trace in (False, True):
        for m in R.metrics_for(SPEC, cell, trace):
            assert callable(R.load_module("metrics", m["name"]).read)


def test_forbidden_modules_compare_whole_names():
    assert R.forbidden_modules({"tpu_ec_torch": 1, "tpu_ec_torch.ops": 1, "tpu_ecx": 1, "jaxtyping": 1}) == []
    assert R.forbidden_modules({"tpu_ec.fields": 1, "jax": 1, "flax.linen": 1, "jaxlib": 1}) == [
        "flax", "jax", "jaxlib", "tpu_ec"]


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(R.BENCH, "reference")
    for f in sorted(os.listdir(ref)):
        if f.endswith(".py"):
            tree = ast.parse(open(os.path.join(ref, f)).read())
            for node in ast.walk(tree):
                mods = [a.name for a in node.names] if isinstance(node, ast.Import) else (
                    [node.module or ""] if isinstance(node, ast.ImportFrom) and node.level == 0 else [])
                for m in mods:
                    assert m.split(".")[0] in {"__future__", "numpy", "torch", "benchmark"}, (f, m)
                    assert not m.startswith("benchmark.") or m.startswith("benchmark.reference"), (f, m)
    code = ("import sys; sys.path.insert(0, sys.argv[1]); import benchmark.reference.ec, "
            "benchmark.reference.limbs, benchmark.reference.params; print(sorted({m.split('.')[0] "
            "for m in sys.modules} & {'jax', 'jaxlib', 'flax', 'tpu_ec', 'tpu_ec_torch'}))")
    out = subprocess.run([sys.executable, "-c", code, R.ROOT], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"


def test_a_run_loads_no_jax():
    """A whole cell run, on the CPU at a tiny size, in a fresh interpreter."""
    code = (
        "import sys, json, torch; sys.path.insert(0, sys.argv[1]); torch.set_num_threads(1)\n"
        "from benchmark import run as R\n"
        "cell = R.Cell('ecfft-16x2p11', R.benchmark_spec(), json.loads(sys.argv[2]))\n"
        "line, _ = R.run_cell(cell, 2**31 + 5, 0.05, True, torch.device('cpu'))\n"
        "print(json.dumps([line['correct'], R.forbidden_modules(), 'tpu_ec_torch' in sys.modules]))\n"
    )
    out = subprocess.run([sys.executable, "-c", code, R.ROOT, json.dumps(TINY["ec_fft"])],
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [True, [], True]


def test_without_a_card_there_is_no_result(no_card):
    out = subprocess.run([sys.executable, os.path.join(R.BENCH, "run.py"), "--workload", "commit-2p20",
                          "--seed", str(2**31 + 9), "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout == ""


def test_benchmark_files_alone_give_no_result(tmp_path):
    shutil.copy(os.path.join(R.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(R.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "benchmark/run.py", "--workload", "ecfft-16x2p11", "--seed", "1",
                          "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env={k: v for k, v in os.environ.items() if k != "PYTHONPATH"})
    assert out.returncode != 0 and out.stdout == ""


def test_a_cell_configuration_and_metric_are_added_as_files(tmp_path, monkeypatch):
    """Copy the benchmark, add a configuration, a traffic, a cell and a
    per-layer metric as new files and entries only, and run the new cell."""
    shutil.copytree(R.BENCH, tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    before = {p: open(p, "rb").read() for p in map(str, (tmp_path / "benchmark").rglob("*")) if os.path.isfile(p)}
    spec = json.loads(json.dumps(SPEC))
    (tmp_path / "benchmark/configs/tiny-bn254.json").write_text(json.dumps({"name": "tiny-bn254"}))
    (tmp_path / "benchmark/workloads/tiny-ecfft.json").write_text(json.dumps(
        {"config": "tiny-bn254", "op": "ec_fft", "curve": "bn254_g1", "log_n": 2, "transforms": 1, "pool": 1,
         "warmup": 1, "trace_ops": 1}))
    (tmp_path / "benchmark/metrics/ops_done.py").write_text("def read(run):\n    return run.ops\n")
    spec["configs"].append({"name": "tiny-bn254", "source": "https://example.org/tiny",
                            "file": "benchmark/configs/tiny-bn254.json", "reduced": [], "why": "a test"})
    spec["workloads"].append({"name": "tiny-ecfft", "config": "tiny-bn254", "traffic": "tiny-ecfft",
                              "chips": 1, "why": "a test"})
    spec["per_layer"].append({"name": "ops_done", "unit": "ops", "better": "higher", "source": "host_clock",
                              "layer": "the harness", "moves": "op_ms", "workloads": ["tiny-ecfft"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(R, "ROOT", str(tmp_path))
    monkeypatch.setattr(R, "BENCH", str(tmp_path / "benchmark"))
    line, _ = R.run_cell(R.Cell("tiny-ecfft", R.benchmark_spec()), 2**31 + 3, 0.05, True, torch.device("cpu"))
    assert line["correct"] and line["metrics"]["ops_done"]["value"] == line["attempted"] >= 1
    assert "ops_done" not in {m["name"] for c in SPEC["workloads"] for m in R.metrics_for(spec, c["name"], True)}
    assert all(open(p, "rb").read() == b for p, b in before.items())


@pytest.mark.cuda
@pytest.mark.parametrize("op", sorted(TINY))
def test_a_tiny_cell_on_the_card(op, card):
    """Each op's path through the program's kernels, at a tiny size, is correct."""
    R.isolate_program_env()
    line, checks = R.run_cell(R.Cell(CELLS[op], SPEC, TINY[op]), 2**31 + 11, 0.2, True, card)
    assert line["correct"], checks
    assert line["device"]["platform"] == "gpu" and line["device"]["busy_s"] > 0
