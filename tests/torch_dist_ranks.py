"""Rank bodies of the distributed-path tests, run on spawned gloo ranks.

``tpu_ec_torch.parallel.run_spmd`` imports this module by name in each
spawned process, so it imports nothing of jax or tpu_ec: the ranks read
their inputs from .npy files the test wrote, run the port's distributed
ops and write what they got back as .npy (or .json) files, which the test
process holds against tpu_ec.  Not a test module (no ``test_`` prefix).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from tpu_ec_torch import config
from tpu_ec_torch.curves.params import ALL_CURVES
from tpu_ec_torch.fields.params import ALL_FIELDS
from tpu_ec_torch.parallel import (DistEcFftKernel, DistFftKernel, DistMultiexpKernel, gather_leading, make_mesh,
                                   shard_leading)
from tpu_ec_torch.parallel import mesh as mesh_mod
from tpu_ec_torch.parallel import ntt_dist


def _load(path: str) -> torch.Tensor:
    return torch.as_tensor(np.load(path).astype(np.int64))


def _save(path: str, t: torch.Tensor) -> None:
    np.save(path, t.cpu().numpy().astype(np.int64))


def ntt_case_name(log_n: int, inverse: bool, route: str) -> str:
    return f"ntt_{route}_{log_n}_{int(inverse)}"


def msm_case_name(n: int, accum: str | None, window: int | None) -> str:
    return f"msm_{n}_{accum or 'default'}_{window or 0}"


def run_all(work: str, ntt_cases: list, msm_cases: list, ec_fft, mesh_cases: list) -> None:
    """Every distributed case of one world size on this rank.

    ``ntt_cases``: (field name, log_n, inverse, route "pease" or "digit");
    the input is ``{work}/ntt_{field}_{log_n}.npy`` (n, L) Montgomery; each
    rank writes its output slab and its twiddle slice.  ``msm_cases``:
    (curve name, n, accum, window), accum None for config's default;
    inputs ``{work}/msm_{n}_{x,y,s}.npy``;
    rank 0 writes the Jacobian result.  ``ec_fft`` (True or "both"): the
    stacked batch ``{work}/ec_{X,Y,Z}.npy`` (B, n, L) transformed and
    gathered on rank 0, with "both" the inverse of that output too.
    ``mesh_cases``: make_mesh's policy cases, one JSON file per rank."""
    mesh = make_mesh()
    r = mesh.rank
    fields = {f.name: f for f in ALL_FIELDS}
    curves = {c.name: c for c in ALL_CURVES}
    cfg = config.get_config()
    for field, log_n, inverse, route in ntt_cases:
        spec = fields[field]
        saved = (ntt_dist.use_digit_local, cfg.ntt_digit_leaf_log)
        if route == "digit":  # both factors are tiny: force the route, leaf 4
            ntt_dist.use_digit_local, cfg.ntt_digit_leaf_log = (lambda log_n1, log_n2: True), 4
        try:
            kern = DistFftKernel(spec, mesh)
            x = _load(os.path.join(work, f"ntt_{field}_{log_n}.npy"))
            y = kern.radix_fft(shard_leading(x, mesh), inverse)
            plan = kern.plan(log_n, inverse)
            if plan.digit != (route == "digit"):
                raise AssertionError(f"{route} case ran on the other route")
        finally:
            ntt_dist.use_digit_local, cfg.ntt_digit_leaf_log = saved
        name = ntt_case_name(log_n, inverse, route)
        _save(os.path.join(work, f"{name}_r{r}.npy"), y)
        _save(os.path.join(work, f"tw_{log_n}_{int(inverse)}_r{r}.npy"), plan.tw)
    for curve, n, accum, window in msm_cases:
        saved = cfg.dist_msm_accum
        cfg.dist_msm_accum = accum or saved
        try:
            kern = DistMultiexpKernel(curves[curve], mesh)
            pts = tuple(_load(os.path.join(work, f"msm_{n}_{c}.npy")) for c in "xy")
            s = _load(os.path.join(work, f"msm_{n}_s.npy"))
            out = kern.multiexp(shard_leading(pts, mesh), shard_leading(s, mesh), window_size=window)
        finally:
            cfg.dist_msm_accum = saved
        others = gather_leading(torch.stack(out), mesh)  # every rank must hold the same point
        if not all(torch.equal(others[3 * j : 3 * j + 3], others[:3]) for j in range(mesh.size)):
            raise AssertionError(f"ranks disagree on {msm_case_name(n, accum, window)}")
        if r == 0:
            _save(os.path.join(work, msm_case_name(n, accum, window) + ".npy"), torch.stack(out))
    if ec_fft:
        from tpu_ec_torch.curves.params import BN254_G1

        P = tuple(_load(os.path.join(work, f"ec_{c}.npy")) for c in "XYZ")
        B = P[0].shape[0]
        kern = DistEcFftKernel(BN254_G1, mesh)
        Y = kern.radix_ec_fft_many(shard_leading(P, mesh))
        outs = [Y] + ([kern.radix_ec_fft_many(Y, inverse=True)] if ec_fft == "both" else [])
        for inverse, out in enumerate(outs):
            full = gather_leading(out, mesh, B)
            if r == 0:
                _save(os.path.join(work, f"ec_out_{inverse}.npy"), torch.stack(full))
    for k, (fail, want, min_devices) in enumerate(mesh_cases):
        mesh_mod_probe = mesh_mod._probe
        mesh_mod._probe = lambda dev, fail=fail: r not in fail
        saved = cfg.min_devices
        cfg.min_devices = min_devices
        try:
            m = make_mesh(want=want, probe=True)
            if m is None:
                got = {"mesh": None}
            else:
                t = torch.tensor([1 << r])
                torch.distributed.all_reduce(t, group=m.group)
                got = {"mesh": [m.size, m.rank], "members": int(t.item())}
        except mesh_mod.DeviceError as e:
            got = {"error": str(e)}
        finally:
            mesh_mod._probe = mesh_mod_probe
            cfg.min_devices = saved
        with open(os.path.join(work, f"mesh_{k}_r{r}.json"), "w") as fh:
            json.dump(got, fh)


class Spawn:
    """``run_spmd(run_all, d, *args)`` for each (d, args) of ``runs``, one
    world size after the other on a background thread, so that the test
    process computes its references meanwhile (and at most one group of
    ranks loads the machine at a time); ``join`` waits and re-raises a
    rank's failure (or a TimeoutError where the ranks outlast ``timeout``)."""

    def __init__(self, runs: list):
        import threading

        from tpu_ec_torch.parallel import run_spmd

        self.error = None

        def body():
            try:
                for d, args in runs:
                    run_spmd(run_all, d, *args, device="cpu")
            except Exception as e:  # noqa: BLE001 -- handed to join
                self.error = e

        self.thread = threading.Thread(target=body, daemon=True)
        self.thread.start()

    def join(self, timeout: float = 900) -> None:
        self.thread.join(timeout)
        if self.thread.is_alive():
            raise TimeoutError(f"the spawned ranks did not finish in {timeout} s")
        if self.error is not None:
            raise self.error
