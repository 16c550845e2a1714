#!/usr/bin/env python3
"""The benchmark of tpu_ec_torch: one cell, one run, one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything is found by name, so that a cell, a configuration or a metric is
added as files:

- the cell in ``BENCHMARK.json`` names its configuration and its traffic;
- ``benchmark/configs/<config>.json`` holds the configuration;
- ``benchmark/workloads/<traffic>.json`` holds the traffic: the op and its
  sizes, the pool of inputs, the warm-up, what the check keeps;
- ``benchmark/ops/<op>.py`` makes the inputs from the seed, drives the
  program's public entry, and checks what it returned against the plain
  reference (``benchmark/reference``);
- ``benchmark/metrics/<metric>.py`` reads one metric from the run;
- ``benchmark/roofline/<op>.py`` counts the op's work for the roofline.

A run: set-up (the kernels' build or its cache, the inputs, ``warmup``
calls), then a closed loop for ``--seconds``: one caller issues the next op
when the last one's result is synchronised and read back.  With ``--trace 1``
a few more ops run under torch.profiler and the per-layer metrics are read;
otherwise the end-to-end metrics.  Then the program's state is freed and the
outputs the check kept are compared with the reference.  The last line of
standard output is the result; the numbers compared, each beside its limit,
are the last lines of standard error.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import sys  # noqa: E402
import traceback  # noqa: E402

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

#: top-level module names the benchmark's process must not hold (whole names:
#: tpu_ec_torch starts with tpu_ec and is the program)
FORBIDDEN = ("jax", "jaxlib", "flax", "tpu_ec")
#: the program's build directory (kernels, digit-NTT tables), at a fixed path
#: inside the checkout so that only a checkout's first run builds
BUILD_DIR = os.path.join(ROOT, "tpu_ec_torch", "_build")


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def benchmark_spec(root: str | None = None) -> dict:
    return load_json(os.path.join(root or ROOT, "BENCHMARK.json"))


def load_module(kind: str, name: str):
    """``benchmark/<kind>/<name>.py`` as a module."""
    path = os.path.join(BENCH, kind, f"{name}.py")
    if not os.path.exists(path):
        raise FileNotFoundError(f"no {kind[:-1] if kind.endswith('s') else kind} named {name!r}: {path}")
    mod_name = f"benchmark.{kind}.{name.replace('-', '_').replace('.', '_')}"
    if mod_name in sys.modules:
        return sys.modules[mod_name]
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def forbidden_modules(modules=None) -> list[str]:
    """Top-level names in ``modules`` (default ``sys.modules``) that are in
    FORBIDDEN, compared whole."""
    names = {m.split(".", 1)[0] for m in (sys.modules if modules is None else modules)}
    return sorted(names & set(FORBIDDEN))


def metrics_for(spec: dict, cell: str, trace: bool) -> list[dict]:
    """The metric entries of BENCHMARK.json that this cell reports in this
    kind of run (a metric without ``workloads`` is every cell's)."""
    group = spec["per_layer"] if trace else spec["end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


class Cell:
    """A cell as BENCHMARK.json, its configuration file and its traffic file
    give it."""

    def __init__(self, name: str, spec: dict, traffic_overrides: dict | None = None):
        entries = {w["name"]: w for w in spec["workloads"]}
        if name not in entries:
            raise KeyError(f"no cell named {name!r} in BENCHMARK.json ({', '.join(entries)})")
        self.name, self.entry = name, entries[name]
        self.chips = self.entry["chips"]
        self.config = load_json(os.path.join(BENCH, "configs", f"{self.entry['config']}.json"))
        self.traffic = load_json(os.path.join(BENCH, "workloads", f"{self.entry['traffic']}.json"))
        if self.traffic.get("config", self.entry["config"]) != self.entry["config"]:
            raise ValueError(f"traffic {self.entry['traffic']!r} is for {self.traffic['config']!r}, "
                             f"the cell for {self.entry['config']!r}")
        self.traffic.update(traffic_overrides or {})


class Run:
    """What one run measured; the metric readers read it."""

    def __init__(self, cell: Cell, trace: bool):
        self.cell, self.trace_on = cell, trace
        self.setup_s = None
        self.latencies_s: list[float] = []
        self.window_s = 0.0
        self.failed = 0
        self.launches: dict = {}
        self.memory_peak_bytes = 0
        self.trace = None  # trace.Trace of the traced ops, with --trace 1
        self.work = None  # the roofline's count of one op

    @property
    def ops(self) -> int:
        return len(self.latencies_s)


class Keeper:
    """What the check will compare: each op's small output, and the large
    output of a uniform sample of ``sample`` ops drawn from the seed
    (reservoir sampling, since the window's op count is not known ahead)."""

    def __init__(self, seed: int, sample: int):
        self.rng = random.Random(seed * 7919 + 17)
        self.sample = sample
        self.small: list = []
        self.large: dict = {}
        self.seen = 0

    def keep(self, i: int, small, large) -> None:
        self.small.append((i, small))
        if large is not None:
            if self.seen < self.sample:
                self.large[self.seen] = (i, large)
            else:
                j = self.rng.randrange(self.seen + 1)
                if j < self.sample:
                    self.large[j] = (i, large)
            self.seen += 1

    def sampled(self) -> list:
        return sorted(self.large.values(), key=lambda t: t[0])


def hard_sync(out) -> None:
    """Synchronise the device and read one element of every output tensor
    back to the host (the pattern of tpu_ec_torch/utils/measure.py)."""
    import torch

    leaves, stack = [], [out]
    while stack:
        x = stack.pop()
        if isinstance(x, torch.Tensor):
            leaves.append(x)
        elif isinstance(x, (tuple, list)):
            stack.extend(x)
    if any(t.device.type == "cuda" for t in leaves):
        torch.cuda.synchronize()
    for t in leaves:
        if t.numel():
            t.reshape(-1)[:1].cpu()


def card(device) -> dict:
    import torch

    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1}


def isolate_program_env() -> None:
    """The program reads TPU_EC_TORCH_* settings from the environment: run it
    on its defaults, with its build directory fixed inside the checkout."""
    for k in [k for k in os.environ if k.startswith("TPU_EC_TORCH_")]:
        del os.environ[k]
    os.environ["TPU_EC_TORCH_BUILD_DIR"] = BUILD_DIR
    os.environ["USE_FLAX"] = "0"


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device, op_class=None) -> tuple[dict, list]:
    """Set up, measure, check.  Returns (result line, the numbers compared as
    (name, value, limit)).  ``op_class`` replaces the op's class (the fault
    tests plant a broken one)."""
    import torch

    from benchmark import trace as tracing

    run = Run(cell, trace)
    traffic = cell.traffic
    op_mod = load_module("ops", traffic["op"])
    t_inputs = time.perf_counter()
    op = (op_class or op_mod.Op)(cell.config, traffic, seed, device)
    pool = op.pool
    t_warmup = time.perf_counter()
    for i in range(traffic.get("warmup", 1)):
        hard_sync(op.call(i % pool))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    print(f"set-up: imports {t_inputs - T0:.3f} s, card and inputs {t_warmup - t_inputs:.3f} s, "
          f"warm-up {time.perf_counter() - t_warmup:.3f} s", file=sys.stderr)
    launches0 = op.launch_counts()
    keeper = Keeper(seed, traffic.get("check_sample", 1))
    errors = []
    run.setup_s = time.perf_counter() - T0

    start = time.perf_counter()
    i = 0
    while time.perf_counter() - start < seconds:
        t = time.perf_counter()
        try:
            out = op.call(i % pool)
            hard_sync(out)
        except Exception:  # an op that raises counts as failed; the window goes on
            run.failed += 1
            errors.append(traceback.format_exc(limit=4))
            out = None
        run.latencies_s.append(time.perf_counter() - t)
        if out is not None:
            keeper.keep(i, *op.keep(out))
        i += 1
    run.window_s = time.perf_counter() - start
    launches1 = op.launch_counts()
    run.launches = {k: launches1[k] - launches0.get(k, 0) for k in launches1}

    if trace and device.type == "cuda":  # the trace reads the card's timeline
        run.trace = tracing.trace_ops(lambda j: op.call(j % pool), traffic.get("trace_ops", 3), hard_sync,
                                      op.hand_kernel_names())
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    run.work = load_module("roofline", traffic["op"]).work(cell.config, traffic)

    op.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = op.check(keeper.small, keeper.sampled()) if run.ops > run.failed else []
    for e in errors[:3]:
        print(e, file=sys.stderr)
    return result_line(run, checks, device), checks


def result_line(run: Run, checks: list, device) -> dict:
    spec = benchmark_spec()
    metrics = {}
    for m in metrics_for(spec, run.cell.name, run.trace_on):
        value = load_module("metrics", m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    dev = card(device)
    dev["memory_peak_bytes"] = run.memory_peak_bytes
    if run.trace is not None:
        dev["busy_s"] = run.trace.busy_s
        dev["window_s"] = run.trace.window_s
    correct = bool(checks) and run.failed == 0 and all(v <= lim for _, v, lim in checks)
    line = {"correct": correct, "attempted": run.ops, "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse_args(argv)
    try:
        cell = Cell(args.workload, benchmark_spec())
    except (KeyError, FileNotFoundError, ValueError) as e:
        print(f"benchmark: {e}", file=sys.stderr)
        return 2
    isolate_program_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"benchmark: the cell needs {cell.chips} CUDA device(s), found {n}; no result", file=sys.stderr)
        return 3
    torch.set_num_threads(min(4, os.cpu_count() or 1))
    device = torch.device("cuda", 0)
    line, checks = run_cell(cell, args.seed, args.seconds, bool(args.trace), device)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, v, lim in checks:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(line))
    return 0


if __name__ == "__main__":
    sys.exit(main())
