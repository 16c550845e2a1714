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

A cell whose ``chips`` is N > 1 runs as N ranks, one process a card
(``on_ranks``): this process is rank 0 and spawns the others; every rank
builds its own op on ``cuda:<rank>`` and runs the same ops in lock step, and
rank 0 gathers what each rank's check compared.  A raise on any rank ends
the run with no result.  A one-card cell spawns nothing and initialises no
process group.
"""

from __future__ import annotations

import time

T0 = time.perf_counter()  # set-up is counted from here

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import random  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
import threading  # noqa: E402
import traceback  # noqa: E402
from datetime import timedelta  # noqa: E402

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
#: how long a harness message of a multi-rank run may wait before it raises:
#: the second guard against a hang, after rank 0's guard thread
GROUP_TIMEOUT = timedelta(seconds=600)
#: the exit code of a multi-rank run that a fault on some rank ended
RANK_FAULT_EXIT = 5


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
    back to the host, so that an op's latency covers all of its work."""
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
    """Set up, measure, check on one device.  Returns (result line, the
    numbers compared as (name, value, limit)).  ``op_class`` replaces the
    op's class (the fault tests plant a broken one)."""
    run, checks = measure(cell, seed, seconds, trace, device, op_class)
    return result_line(run, checks, device), checks


def measure(cell: Cell, seed: int, seconds: float, trace: bool, device, op_class=None,
            ranks: Ranks | None = None) -> tuple[Run, list]:
    """Set-up, the window, the trace and the check on this process's device.
    ``ranks`` (a multi-rank cell's, else None) puts the ranks in lock step:
    a barrier after the warm-up, rank 0's clock deciding each op, traces
    taken again together; and an op that raises ends the run instead of
    counting as failed, since the other ranks would wait for it."""
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
    if ranks is not None:
        ranks.barrier()
    if ranks is None or ranks.rank == 0:
        print(f"set-up: imports {t_inputs - T0:.3f} s, card and inputs {t_warmup - t_inputs:.3f} s, "
              f"warm-up {time.perf_counter() - t_warmup:.3f} s", file=sys.stderr)
    launches0 = op.launch_counts()
    keeper = Keeper(seed, traffic.get("check_sample", 1))
    errors = []
    run.setup_s = time.perf_counter() - T0

    def more() -> bool:  # on a multi-rank cell, rank 0's clock decides
        go = time.perf_counter() - start < seconds
        return go if ranks is None else ranks.decide(go)

    start = time.perf_counter()
    i = 0
    while more():
        t = time.perf_counter()
        try:
            out = op.call(i % pool)
            hard_sync(out)
        except Exception:  # an op that raises counts as failed; the window goes on
            if ranks is not None:
                raise
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
                                      op.hand_kernel_names(), agree=None if ranks is None else ranks.all)
    if device.type == "cuda":
        run.memory_peak_bytes = torch.cuda.max_memory_allocated(device)
    run.work = load_module("roofline", traffic["op"]).work(cell.config, traffic)

    op.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = op.check(keeper.small, keeper.sampled()) if run.ops > run.failed else []
    for e in errors[:3]:
        print(e, file=sys.stderr)
    return run, checks


def result_line(run: Run, checks: list, device, parts: list | None = None) -> dict:
    """The result line of rank 0's run.  ``parts`` (a multi-rank run's, in
    rank order, rank 0's first) adds the other ranks: ``checks`` are then
    every rank's numbers under ``r<k>/<name>``, and ``device`` the largest
    peak, ``count`` N and ``ranks``."""
    spec = benchmark_spec()
    if parts is not None:
        run.memory_peak_bytes = max(p["memory_peak_bytes"] for p in parts)
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
    if parts is not None:
        correct = correct and all(p["checks"] for p in parts)
        dev["count"] = len(parts)
        dev["ranks"] = [{k: p[k] for k in RANK_DEVICE_KEYS if k in p} for p in parts]
        if run.trace is not None:  # busy time averaged over the cards, as the window
            dev["busy_s"] = sum(p["busy_s"] for p in parts) / len(parts)
            dev["window_s"] = sum(p["window_s"] for p in parts) / len(parts)
    line = {"correct": correct, "attempted": run.ops, "failed": run.failed, "metrics": metrics, "device": dev}
    if run.trace is not None:
        line["breakdown"] = run.trace.breakdown()
    line["checks"] = {name: {"value": v, "limit": lim} for name, v, lim in checks}
    return line


#: what each rank reports under the result line's ``device.ranks``
RANK_DEVICE_KEYS = ("rank", "attempted", "memory_peak_bytes", "busy_s", "window_s")


class Ranks:
    """This process's place in a multi-rank run, and the gloo group that
    carries the harness's own messages, so that they never touch a card."""

    def __init__(self, rank: int, world: int, group):
        self.rank, self.world, self.group = rank, world, group

    def _flag(self, value: bool, op) -> bool:
        import torch
        import torch.distributed as dist

        t = torch.tensor([int(value)])
        if op is None:
            dist.broadcast(t, src=0, group=self.group)
        else:
            dist.all_reduce(t, op=op, group=self.group)
        return bool(t.item())

    def decide(self, go: bool) -> bool:
        """Rank 0's ``go``, on every rank: continue or stop."""
        return self._flag(go, None)

    def all(self, ok: bool) -> bool:
        """Whether ``ok`` holds on every rank."""
        import torch.distributed as dist

        return self._flag(ok, dist.ReduceOp.MIN)

    def barrier(self) -> None:
        import torch.distributed as dist

        dist.barrier(group=self.group)

    def gather(self, obj) -> list | None:
        """Every rank's ``obj`` in rank order on rank 0; None elsewhere."""
        import torch.distributed as dist

        out = [None] * self.world if self.rank == 0 else None
        dist.gather_object(obj, out, dst=0, group=self.group)
        return out


def join_ranks(rank: int, world: int, store_path: str, device_type: str) -> tuple[Ranks, object]:
    """Join the default process group of ``world`` ranks at the ``FileStore``
    ``store_path`` as the program's own ranks join it (``init_rank``: NCCL on
    ``cuda:<rank>``, gloo on the CPU), with the variables torchrun would set;
    the program finds its mesh in it.  The harness's messages get a gloo
    group of their own, whose collectives raise after ``GROUP_TIMEOUT``."""
    import torch
    import torch.distributed as dist
    from tpu_ec_torch.parallel.mesh import init_rank

    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world))
    init_rank(rank, world, store_path, device_type)
    device = torch.device("cuda", rank) if device_type == "cuda" else torch.device("cpu")
    return Ranks(rank, world, dist.new_group(backend="gloo", timeout=GROUP_TIMEOUT)), device


def _fault(tmp: str, why: str) -> None:
    """End rank 0 with ``RANK_FAULT_EXIT`` and no result."""
    print(f"benchmark: {why}; every rank ended, no result", file=sys.stderr, flush=True)
    shutil.rmtree(tmp, ignore_errors=True)
    sys.stdout.flush()
    os._exit(RANK_FAULT_EXIT)


def _watch(ranks_ctx, tmp: str) -> None:
    """Rank 0's guard over the ranks it spawned, on a thread of its own: the
    spawn context's ``join`` finds a rank that exited non-zero and ends the
    others, and this ends rank 0, so that a fault never leaves the rest
    blocked in a collective.  It alone reaps the ranks."""
    try:
        while not ranks_ctx.join(0.5):
            pass
    except Exception as e:  # ProcessExitedException: the other ranks are ended
        _fault(tmp, f"rank {e.error_index + 1} exited with code {getattr(e, 'exit_code', None)}")


def _exit_with(parent: int) -> None:
    """End this process once its parent, rank 0, is gone (a rank blocked in
    a collective runs no signal handler, so the spawn's own SIGINT on the
    parent's death may not end it)."""

    def watch():
        while os.getppid() == parent:
            time.sleep(1.0)
        os._exit(RANK_FAULT_EXIT)

    threading.Thread(target=watch, name="bench-parent-watch", daemon=True).start()


def _rank_main(index: int, world: int, store_path: str, device_type: str, job, args: tuple, parent: int) -> None:
    """Rank ``index + 1`` of ``on_ranks``, in a spawned process."""
    _exit_with(parent)
    import torch
    import torch.distributed as dist

    torch.set_num_threads(1 if device_type == "cpu" else max(1, min(4, (os.cpu_count() or 1) // world)))
    try:
        ranks, device = join_ranks(index + 1, world, store_path, device_type)
        job(ranks, device, *args)
        dist.destroy_process_group()
        code = 0
    except BaseException:  # ends the process below: its exit code tells rank 0's guard
        traceback.print_exc()
        code = 1
    sys.stdout.flush()
    sys.stderr.flush()
    os._exit(code)  # no interpreter teardown, which can wait on a communicator a peer left


def on_ranks(world: int, device_type: str, job, args: tuple):
    """``job(ranks, device, *args)`` on ``world`` ranks, one process a
    device, SPMD; returns rank 0's value.  This process is rank 0: it loads
    the program's kernels first (on a checkout's first run, one nvcc build
    instead of one a rank), then spawns ranks 1..world-1 with
    torch.multiprocessing; they meet at a ``FileStore`` in a fresh directory
    under ``TMPDIR``.  ``job`` is pickled by name, as are its ``args``.

    A raise on any rank ends this process with ``RANK_FAULT_EXIT`` and
    every rank ended (``_watch``); a rank whose parent is gone ends itself;
    a harness message that waits ``GROUP_TIMEOUT`` raises."""
    import torch.distributed as dist
    import torch.multiprocessing as mp

    if device_type == "cuda":
        from benchmark.program import preload_kernels

        preload_kernels()
    tmp = tempfile.mkdtemp(prefix="bench-ranks-")
    store = os.path.join(tmp, "store")
    ctx = mp.start_processes(_rank_main, args=(world, store, device_type, job, args, os.getpid()),
                             nprocs=world - 1, join=False, start_method="spawn")
    guard = threading.Thread(target=_watch, args=(ctx, tmp), name="bench-ranks-guard", daemon=True)
    guard.start()
    why = None
    try:
        ranks, device = join_ranks(0, world, store, device_type)
        out = job(ranks, device, *args)
        dist.destroy_process_group()
    except BaseException:  # the other ranks may wait in a collective for this one
        traceback.print_exc()
        why = "rank 0 raised"
    if why is None:
        guard.join(60.0)  # the ranks end once they have sent their part
        if guard.is_alive():
            why = "a rank did not end within 60 s of the run"
    if why is not None:
        print(f"benchmark: {why}; ending every rank", file=sys.stderr, flush=True)
        for p in ctx.processes:  # a signal only: the guard reaps them, and ends this process
            p.kill()
        guard.join(60.0)
        _fault(tmp, why)
    shutil.rmtree(tmp, ignore_errors=True)
    return out


def _measure_rank(ranks: Ranks, device, cell: Cell, seed: int, seconds: float, trace: bool, op_class):
    """One rank's part of a multi-rank cell: ``measure``, then what rank 0
    needs of it.  Rank 0 gets (its Run, every rank's part)."""
    run, checks = measure(cell, seed, seconds, trace, device, op_class, ranks)
    part = {"rank": ranks.rank, "attempted": run.ops, "memory_peak_bytes": run.memory_peak_bytes,
            "checks": checks, "kind": card(device)["kind"], "forbidden": forbidden_modules()}
    if run.trace is not None:
        part.update(busy_s=run.trace.busy_s, window_s=run.trace.window_s)
    parts = ranks.gather(part)
    return (run, parts) if ranks.rank == 0 else None


def run_ranks(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str = "cuda",
              op_class=None) -> tuple[dict, list, list]:
    """A cell on ``cell.chips`` ranks (``on_ranks``): every rank runs
    ``measure`` on its own op, rank 0 reports.  Returns (result line, every
    rank's numbers compared, the forbidden modules ranks 1.. hold)."""
    run, parts = on_ranks(cell.chips, device_type, _measure_rank, (cell, seed, seconds, trace, op_class))
    kinds = {p["kind"] for p in parts}
    if len(kinds) != 1:
        raise RuntimeError(f"the ranks' cards differ: {sorted(kinds)}")
    if {p["attempted"] for p in parts} != {run.ops}:
        raise RuntimeError(f"the ranks ran different numbers of ops: {[p['attempted'] for p in parts]}")
    checks = [(f"r{p['rank']}/{name}", v, lim) for p in parts for name, v, lim in p["checks"]]
    found = [f"{m} (rank {p['rank']})" for p in parts[1:] for m in p["forbidden"]]
    import torch

    device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
    return result_line(run, checks, device, parts), checks, found


def run(cell: Cell, seed: int, seconds: float, trace: bool, device_type: str = "cuda",
        op_class=None) -> tuple[dict, list, list]:
    """One run of a cell: (result line, the numbers compared, the forbidden
    modules held).  One card: ``run_cell`` in this process; more: ranks.
    This process's modules are looked at last, once the result line (and
    with it every metric reader) is made."""
    if cell.chips > 1:
        line, checks, found = run_ranks(cell, seed, seconds, trace, device_type, op_class)
    else:
        import torch

        device = torch.device("cuda", 0) if device_type == "cuda" else torch.device("cpu")
        (line, checks), found = run_cell(cell, seed, seconds, trace, device, op_class), []
    return line, checks, found + forbidden_modules()


def report(line: dict, checks: list, found: list) -> int:
    """Print the result (the numbers compared on standard error, the line
    last on standard output) and return the exit code; nothing where a
    forbidden module was found."""
    if found:
        print(f"benchmark: the process holds {', '.join(found)}; no result", file=sys.stderr)
        return 4
    for name, v, lim in checks:
        print(f"check {name}: {v} (limit {lim})", file=sys.stderr)
    print(json.dumps(line))
    return 0


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
    return report(*run(cell, args.seed, args.seconds, bool(args.trace)))


if __name__ == "__main__":
    sys.exit(main())
