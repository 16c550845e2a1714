#!/usr/bin/env python3
"""The readings that set the check's limits, on the card at a cell's own size.

    python3 benchmark/control.py --workload <cell> --seconds <s> --seeds <n> [<n> ...]

For each seed, in one process: the cell's set-up, a closed loop of
``--seconds``, then the numbers the check compares for the program's outputs
(the lower reading) and for the control's (the upper reading): the plain
reference put in the program's place at one bit less of scalar precision
(each op's ``control``).  One JSON line a seed.  The benchmark's own runs do
not run the control.  A cell on N > 1 cards runs on N ranks, as
``benchmark/run.py`` runs it (``on_ranks``): every rank reads its own
numbers, and rank 0 prints rank k's as ``r<k>/<name>``.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from benchmark import run as bench  # noqa: E402


def readings(cell, seed: int, seconds: float, device, sample: int | None = None, ranks=None) -> dict:
    """{"program": {name: value}, "control": {name: value}} of one seed
    (``ranks``: a multi-rank cell's, which puts the loop in lock step)."""
    import torch

    traffic = cell.traffic
    op = bench.load_module("ops", traffic["op"]).Op(cell.config, traffic, seed, device)
    for i in range(traffic.get("warmup", 1)):
        bench.hard_sync(op.call(i % op.pool))
    if ranks is not None:
        ranks.barrier()
    keeper = bench.Keeper(seed, sample or traffic.get("check_sample", 1))
    start, i = time.perf_counter(), 0

    def more() -> bool:
        go = time.perf_counter() - start < seconds
        return go if ranks is None else ranks.decide(go)

    while more():
        out = op.call(i % op.pool)
        bench.hard_sync(out)
        keeper.keep(i, *op.keep(out))
        i += 1
    op.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    small, sampled = keeper.small, keeper.sampled()
    got = {name: v for name, v, _ in op.check(small, sampled)}
    ctl = {name: v for name, v, _ in op.check(*op.control(small, sampled))}
    return {"ops": i, "program": got, "control": ctl}


def _rank_readings(ranks, device, cell, seeds, seconds: float, sample) -> None:
    """Every seed's readings on one rank; rank 0 prints each seed's line."""
    for seed in seeds:
        t = time.perf_counter()
        parts = ranks.gather(readings(cell, seed, seconds, device, sample, ranks))
        if ranks.rank == 0:
            line = {"workload": cell.name, "seed": seed, "ops": parts[0]["ops"]}
            for side in ("program", "control"):
                line[side] = {f"r{k}/{name}": v for k, p in enumerate(parts) for name, v in p[side].items()}
            print(json.dumps({**line, "s": time.perf_counter() - t}), flush=True)


def rank_readings(cell, seeds, seconds: float, device_type: str = "cuda", sample: int | None = None) -> None:
    """``readings`` of each seed on ``cell.chips`` ranks, one JSON line a seed."""
    bench.on_ranks(cell.chips, device_type, _rank_readings, (cell, seeds, seconds, sample))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--check-sample", type=int, default=None,
                   help="ops whose large outputs are compared (default: the traffic's check_sample)")
    args = p.parse_args(argv)
    cell = bench.Cell(args.workload, bench.benchmark_spec())
    bench.isolate_program_env()
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"control: the cell needs {cell.chips} CUDA device(s)", file=sys.stderr)
        return 3
    if cell.chips > 1:
        rank_readings(cell, args.seeds, args.seconds, "cuda", args.check_sample)
        return 0
    device = torch.device("cuda", 0)
    for seed in args.seeds:
        t = time.perf_counter()
        r = readings(cell, seed, args.seconds, device, args.check_sample)
        print(json.dumps({"workload": cell.name, "seed": seed, **r, "s": time.perf_counter() - t}), flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
