#!/usr/bin/env python3
"""Time the digit NTT's two ways of building a Bailey table, the evidence
for the table thresholds of ``ops/ntt_digit.py``.

    python3 -m tpu_ec_torch.utils.table_times

For each BLS12-381 Fr transform of 2^k (default leaf), the level-0 table
(log_m = k, log_n1 = k - plan[0]): the host routine ``inter_table288_np``
(numpy Montgomery, one thread) at 2^16 .. 2^22 (~3 minutes), and K1's row
doubling on the card, ``inter_table288_device``, at 2^16 .. 2^26 (host
clock around a synchronised call, after a warm-up call that builds the
kernels), with the card's peak memory; where both ran, the two tables are
held equal.  Also the factored seeds of the 2^26 level
(``_factored_seeds``).  Prints one JSON line with the card's name and
power limit; exits 1 without a card.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
import types


HOST_SIZES = (16, 18, 20, 22)
CARD_SIZES = (16, 18, 20, 22, 24, 26)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("table_times: no CUDA device available", file=sys.stderr)
        return 1
    from tpu_ec_torch.fields.params import BLS12_381_FR
    from tpu_ec_torch.ops import ntt_digit as nd
    from tpu_ec_torch.ops.ntt import get_domain

    spec = BLS12_381_FR
    dev = torch.device("cuda")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True, timeout=60).stdout.strip().splitlines()[0]

    def shape(k):
        return k, k, k - nd.DigitDomain._plan(k, nd.leaf_log(k))[0]

    out = {"card": card, "host_s": {}, "card_ms": {}, "card_peak_gib": {}}
    host = {}
    for k in HOST_SIZES:
        log_n, log_m, log_n1 = shape(k)
        t0 = time.perf_counter()
        host[k] = nd.inter_table288_np(spec, get_domain(spec, log_n).omega, log_n, log_m, log_n1)
        out["host_s"][f"2^{k}"] = time.perf_counter() - t0
        print(f"host table 2^{k} (n1 = 2^{log_n1}): {out['host_s'][f'2^{k}']:.2f} s", flush=True)
    build = lambda k: nd.inter_table288_device(spec, get_domain(spec, k).omega, *shape(k), dev)
    build(16)  # warm-up: the kernels' build and load
    for k in CARD_SIZES:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        t0 = time.perf_counter()
        table = build(k)
        torch.cuda.synchronize()
        out["card_ms"][f"2^{k}"] = (time.perf_counter() - t0) * 1e3
        out["card_peak_gib"][f"2^{k}"] = (torch.cuda.max_memory_allocated() - base) / 2**30
        if k in host and not np.array_equal(table.permute(2, 0, 1).cpu().numpy(), host[k].astype(np.int32)):
            print(f"table 2^{k}: the card's table differs from the host's", file=sys.stderr)
            return 1
        print(f"card table 2^{k}: {out['card_ms'][f'2^{k}']:.2f} ms, peak {out['card_peak_gib'][f'2^{k}']:.3f} GiB",
              flush=True)
        del table
    log_n, log_m, log_n1 = shape(26)
    dom = types.SimpleNamespace(spec=spec, omega=get_domain(spec, log_n).omega, log_n=log_n)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    nd._factored_seeds(dom, log_m, log_n1, dev)
    torch.cuda.synchronize()
    out["factored_seeds_2^26_ms"] = (time.perf_counter() - t0) * 1e3
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
