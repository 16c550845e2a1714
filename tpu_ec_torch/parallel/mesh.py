"""The device mesh of the distributed ops: a torch.distributed process group.

PyTorch counterpart of ``tpu_ec/parallel/mesh.py``.  The reference's
multi-device story is host threads that hand work to one context a GPU and
sum on the host (``ec-gpu-proxy/src/fft.rs:211-246``,
``multiexp.rs:324-400``); tpu_ec runs one program over a
``jax.sharding.Mesh`` with collectives on the chips' links.  The port runs
SPMD over ``torch.distributed``: one process a card, NCCL between cards
(one rank a card: NCCL refuses two ranks of one communicator on one card),
gloo between CPU processes.  A :class:`Mesh` is a process group, its size,
this rank's place in it (tpu_ec's ``lax.axis_index``) and this rank's
device; a tensor every rank holds is replicated, and ``shard_leading``
gives each rank its contiguous slab of the leading axis.  Under torchrun
(``torchrun --nproc-per-node N``) each rank calls ``init_process_group``
itself; :func:`run_spmd` spawns the ranks of one machine from a
``FileStore`` in a temporary directory (no port to pick).

Degraded startup (the reference's "log and skip a device whose kernels
fail to build, fail only when none is left", fft.rs:169-186,
multiexp.rs:288-307): :func:`make_mesh` can probe each rank's device with a
tiny K1 launch and falls back to the largest power-of-two subset of the
ranks that work, at least config ``min_devices``; it raises
:class:`~tpu_ec_torch.errors.DeviceError` when nothing works.
"""

from __future__ import annotations

import os
import tempfile

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from ..config import get_config, get_logger
from ..errors import DeviceError
from ..fields.limbs import storage_dtype
from ..fields.params import BN254_FR
from ..kernels.mont import mont_mul


class Mesh:
    """A 1-D mesh: a process group (None: the default group), its size d,
    this rank's place in it and this rank's device."""

    def __init__(self, group=None, device=None):
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.device = torch.device(device) if device is not None else _rank_device(group)

    def __repr__(self) -> str:
        return f"Mesh(size={self.size}, rank={self.rank}, device={self.device})"


def backend_device_type(backend_config: str, cuda_available: bool) -> str:
    """The device type ("cuda" or "cpu") of a group from its device-backend
    map (``dist.get_backend_config``: "cuda:nccl", "cpu:gloo,cuda:nccl" for
    ``init_process_group()`` with no backend, "cpu:gloo,cuda:gloo" for
    "gloo").  NCCL among the backends means the card (a DeviceError without
    one); gloo alone means the CPU; anything else is refused rather than
    guessed."""
    pairs = [part.split(":") if ":" in part else ["cuda", part] for part in backend_config.split(",")]
    backends = {dev.strip(): name.strip() for dev, name in pairs}
    if "nccl" in backends.values():
        if backends.get("cuda") != "nccl":
            raise DeviceError(f"process group backend {backend_config!r}: NCCL is not the CUDA backend")
        if not cuda_available:
            raise DeviceError("an NCCL group needs a CUDA device on every rank")
        return "cuda"
    if set(backends.values()) == {"gloo"}:
        return "cpu"
    raise DeviceError(f"process group backend {backend_config!r}: the mesh runs on NCCL (card) or gloo (CPU) only")


def _rank_device(group=None) -> torch.device:
    """This rank's device: cuda:{local rank} where NCCL is among the group's
    backends (made current, so that the communicator starts on it), the CPU
    where gloo is its only backend (:func:`backend_device_type`)."""
    if backend_device_type(dist.get_backend_config(group), torch.cuda.is_available()) == "cpu":
        return torch.device("cpu")
    local = int(os.environ.get("LOCAL_RANK", dist.get_rank() % torch.cuda.device_count()))
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    return dev


def _probe(device: torch.device) -> bool:
    """True if the device runs a tiny K1 launch and gives the right product
    (the reference's "kernel builds" check, fft.rs:169-186)."""
    try:
        one = torch.tensor(BN254_FR.one_limbs, dtype=torch.int64).to(device, storage_dtype(device))
        got = mont_mul(BN254_FR, one.unsqueeze(0), one.unsqueeze(0))
        return bool(torch.equal(got[0].cpu(), one.cpu()))
    except Exception:  # noqa: BLE001 -- any failure marks the device bad
        return False


def make_mesh(group=None, *, want: int | None = None, probe: bool = False) -> Mesh | None:
    """The mesh over ``group`` (None: the default group), called on every
    rank of it.

    ``want``: the ranks wanted; with fewer usable, the mesh degrades to the
    largest power-of-two subset (at least config ``min_devices``, else
    :class:`DeviceError`) with a warning.  ``probe=True`` runs a tiny K1
    launch on each rank's device first; the ranks all-gather the results
    and leave out the ranks that failed.  A mesh over fewer ranks than the
    group is a new group of the first usable ranks (``dist.new_group``); the
    ranks left out get None and take no part in its collectives."""
    log = get_logger("tpu_ec_torch.parallel")
    if not dist.is_initialized():
        raise DeviceError("torch.distributed is not initialised: call init_process_group on every rank first")
    here = Mesh(group)
    ranks = list(range(here.size))
    if probe:
        ok = torch.tensor([int(_probe(here.device))], device=here.device)
        flags = [torch.zeros_like(ok) for _ in ranks]
        dist.all_gather(flags, ok, group=group)
        ranks = [r for r, f in zip(ranks, flags) if int(f.item())]
        for r in sorted(set(range(here.size)) - set(ranks)):
            log.error("rank %d failed the probe; skipping it", r)
    if not ranks:
        raise DeviceError("no working device on any rank")
    if want is not None and len(ranks) < want:
        usable = 1 << (len(ranks).bit_length() - 1)
        if usable < get_config().min_devices:
            raise DeviceError(f"only {len(ranks)} usable devices; min_devices={get_config().min_devices}")
        log.warning("requested %d devices, only %d usable; degrading to %d", want, len(ranks), usable)
        ranks = ranks[:usable]
    elif want is not None:
        ranks = ranks[:want]
    log.info("mesh over %d of %d rank(s)", len(ranks), here.size)
    if len(ranks) == here.size:
        return here
    members = [r if group is None else dist.get_global_rank(group, r) for r in ranks]
    if here.rank not in ranks:
        return None
    sub = dist.new_group(members, use_local_synchronization=True)
    return Mesh(sub, here.device)


def _pad_rows(t: torch.Tensor, rows: int) -> torch.Tensor:
    pad = rows - t.shape[0]
    return torch.cat([t, t.new_zeros((pad,) + t.shape[1:])]) if pad else t


def shard_leading(x, mesh: Mesh):
    """This rank's contiguous slab of the leading axis of a global tensor
    (or of each tensor of a tuple, such as point coordinates), on the
    mesh's device: the rows are zero-padded to a multiple of d (zero
    scalars, (0, 0) identity points, as tpu_ec pads) and rank k takes rows
    [k n/d, (k + 1) n/d)."""
    if isinstance(x, (tuple, list)):
        return tuple(shard_leading(t, mesh) for t in x)
    per = -(-x.shape[0] // mesh.size)
    lo = mesh.rank * per
    return _pad_rows(x[lo : lo + per], per).to(mesh.device).contiguous()


def gather_leading(y, mesh: Mesh, n: int | None = None):
    """The inverse of :func:`shard_leading`: every rank's slab, concatenated
    in rank order on every rank (the first ``n`` rows where given)."""
    if isinstance(y, (tuple, list)):
        return tuple(gather_leading(t, mesh, n) for t in y)
    out = all_gather_rows(y, mesh)
    return out if n is None else out[:n]


def all_gather_rows(y: torch.Tensor, mesh: Mesh) -> torch.Tensor:
    """Every rank's y, concatenated along the leading axis in rank order
    (the concatenated output form, the one gloo takes too)."""
    y = y.contiguous()
    out = y.new_empty((mesh.size * y.shape[0],) + tuple(y.shape[1:]))
    # all_gather_single is the newer name of all_gather_into_tensor
    gather = getattr(dist, "all_gather_single", dist.all_gather_into_tensor)
    gather(out, y, group=mesh.group)
    return out


def init_rank(rank: int, world_size: int, store_path: str, device="cuda") -> None:
    """Join a process group of ``world_size`` ranks that meet at the
    ``FileStore`` ``store_path``: NCCL on cuda:{rank} (made current first),
    gloo with one intra-op thread on the CPU."""
    os.environ["LOCAL_RANK"] = str(rank)
    if torch.device(device).type == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    store = dist.FileStore(store_path, world_size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=world_size)


def _spmd_main(rank: int, fn, world_size: int, store_path: str, device: str, args: tuple) -> None:
    init_rank(rank, world_size, store_path, device)
    try:
        fn(*args)
    finally:
        dist.destroy_process_group()


def run_spmd(fn, world_size: int, *args, device="cuda") -> None:
    """Run ``fn(*args)`` on ``world_size`` spawned ranks of one machine, in a
    process group made for the call (``init_rank``; one card a rank on
    "cuda").  ``fn`` must be importable by name (module level); it makes its
    mesh with :func:`make_mesh`.  A rank that raises fails the call
    (``torch.multiprocessing.ProcessRaisedException``); fewer cards than
    ranks raise :class:`DeviceError` before any spawn."""
    dev = torch.device(device)
    if dev.type == "cuda" and (not torch.cuda.is_available() or torch.cuda.device_count() < world_size):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        raise DeviceError(f"{world_size} ranks need {world_size} CUDA devices, found {have}")
    with tempfile.TemporaryDirectory() as tmp:
        mp.spawn(_spmd_main, args=(fn, world_size, os.path.join(tmp, "store"), dev.type, args),
                 nprocs=world_size, join=True)
