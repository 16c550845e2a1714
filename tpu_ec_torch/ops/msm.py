"""Pippenger multi-scalar multiplication (MSM / "multiexp") entry point.

PyTorch counterpart of ``tpu_ec/ops/msm.py``: window digits
(``make_digits``, signed or unsigned), chunk sizing by device memory
(``calc_chunk_size``) and ``MultiexpKernel.multiexp`` on the pair-halving
engine (``ops/msm_pair.py``, the one "auto" runs for signed digits, G1 and
G2), the co-Z engine (``ops/msm_coz.py``, G1-only), the scan engine
(``ops/msm_scan.py``, tpu_ec's G2 engine), the sorted engine
(``ops/msm_sorted.py``, run-halving rounds; G1 and G2) or the bucket lattice
below (``msm_lattice``, the one engine that takes unsigned digits, G1 and
G2), with oversized inputs split into chunks whose partial sums are added
on the device, and ``MultiexpKernel.multiple_multiexp``, the batch of
independent MSMs of the AMT workload (``tpu_ec/ops/msm_batch.py``), in
slabs of chunks sized by device memory (``batch_slab``).  The window
comes from the argument, then (one MSM) ``config.msm_window``, then the
card's measured table (``ops/autotune.py``), then the engine's model.
"""

from __future__ import annotations

import torch

from ..config import get_config, get_logger
from ..curves.params import CurveSpec
from ..curves.point import PointOps
from ..errors import Aborted
from ..fields.limbs import resolve_device
from ..kernels.point import horner, lattice_lanes
from ..utils.timer import phase

SCALAR_BITS = 256  # Fr limb width for both supported curves (16 x 16-bit)


def _window_raws(scalars: torch.Tensor, w: int, num_windows: int) -> list[torch.Tensor]:
    """Unsigned base-2^w digits of (n, Ls+1) zero-padded scalar limbs; window
    j covers bits [j*w, (j+1)*w).  Computed in int64 (a 32-bit merge of two
    half-limbs does not fit int32)."""
    s = scalars.to(torch.int64)
    mask = (1 << w) - 1
    out = []
    for j in range(num_windows):
        li, ofs = divmod(j * w, 16)
        merged = s[:, li] | (s[:, li + 1] << 16)
        out.append((merged >> ofs) & mask)
    return out


def _recode_signed(raws: list[torch.Tensor], w: int) -> torch.Tensor:
    """Carry-chain signed recode: digits in [-2^(w-1), 2^(w-1)]."""
    half = 1 << (w - 1)
    digits = []
    c = torch.zeros_like(raws[0])
    for r in raws:
        t = r + c
        c = (t > half).to(t.dtype)
        digits.append(t - (c << w))
    return torch.stack(digits, dim=-1)


def make_digits(scalars: torch.Tensor, w: int, num_windows: int, signed: bool) -> torch.Tensor:
    """(n, Ls+1) zero-padded plain scalar limbs -> (n, W) int32 digits."""
    raws = _window_raws(scalars, w, num_windows)
    d = _recode_signed(raws, w) if signed else torch.stack(raws, dim=-1)
    return d.to(torch.int32)


# ---------------------------------------------------------------------------
# The bucket lattice (tpu_ec/ops/msm.py:57-224): the engine of unsigned
# digits, and of method="lattice" with either sign
# ---------------------------------------------------------------------------


def default_window_size(n: int) -> int:
    """The lattice's window: tpu_ec's model, ~log2(n) - 10, in [2, 12]
    (1 for n <= 1)."""
    if n <= 1:
        return 1
    return max(2, min(12, n.bit_length() - 11))


def default_num_groups(n: int, window_size: int) -> int:
    """The lattice's groups G, a power of two: tpu_ec's model, G x W ~ 4096
    lanes, halved while G x W exceeds 4 n."""
    num_windows = -(-SCALAR_BITS // window_size)
    g = max(1, 4096 // num_windows)
    g = 1 << (g - 1).bit_length()  # round up to a power of two (the tree needs it)
    while g > 1 and g * num_windows > 4 * n:
        g //= 2
    return g


def prepare_inputs(bases, scalars: torch.Tensor, num_groups: int):
    """Pad n to m G with identity points (0, 0) and zero scalars, add one
    zero limb to the scalars (the windows' cross-limb reads) and reshape to
    the (m, G) lattice: -> ((x, y) of (m, G, L), (m, G, Ls + 1), m)."""
    n = bases[0].shape[0]
    G = num_groups
    m = -(-n // G)
    pad = m * G - n
    points = tuple(torch.cat([c, c.new_zeros((pad,) + c.shape[1:])]).reshape(m, G, -1) for c in bases)
    s = torch.cat([scalars, scalars.new_zeros((n, 1))], dim=1)
    s = torch.cat([s, s.new_zeros((pad, s.shape[1]))]).reshape(m, G, -1)
    return points, s, m


def lattice_steps(G: int) -> dict:
    """K3 launches of ``msm_lattice`` on a lattice of G groups, whatever
    its steps, window and sign: one lattice entry (every lane's buckets and
    running sum), log2(G) adds (the group tree) and one Horner."""
    return {"lattice": 1, "add": G.bit_length() - 1, "horner": 1}


def msm_lattice(ops: PointOps, points, scalars: torch.Tensor, *, window_size: int, signed: bool):
    """One MSM on the bucket lattice -> a Jacobian point, batch (1,).

    ``points``: affine (x, y) of (m, G, L); ``scalars``: (m, G, Ls + 1)
    plain zero-padded limbs (``prepare_inputs``).  Each (group, window)
    lane adds step t's point of its group into bucket |d| of its digit d (y
    negated where a signed digit is negative; a zero digit adds nothing:
    tpu_ec adds it into slot 0, which nothing reads), then reduces its
    buckets by tpu_ec's triangular running sum, in one K3 launch
    (``kernels.point.lattice_lanes``: one tile of lanes a lane, each bucket
    in tpu_ec's step order from the identity).  Then the halving tree over
    the groups (log2 G K3 adds) and the window combine in one K3 Horner
    launch (its doubling and add order is tpu_ec's loop's, so the Jacobian
    result is tpu_ec's bit for bit)."""
    w = window_size
    W = -(-SCALAR_BITS // w)
    nbuckets = (1 << (w - 1) if signed else (1 << w) - 1) + 1
    m, G = scalars.shape[:2]
    x, y = points
    with phase("msm/digits"):
        digits = make_digits(scalars.reshape(m * G, -1), w, W, signed).reshape(m, G * W)
    with phase("msm/lattice"):
        acc = lattice_lanes(ops.spec.base, x, y, digits, nbuckets, signed, ext=ops.spec.ext)
        g = G
        while g > 1:
            acc = ops.add(tuple(c[: g // 2] for c in acc), tuple(c[g // 2 : g] for c in acc))
            g //= 2
    with phase("msm/horner"):
        return horner(ops.spec.base, tuple(c[0] for c in acc), w, ext=ops.spec.ext)


# int32 coordinate-sized arrays live per point and window at the peak of the
# window-batched pair engine (gathered rows, round-0 output, temporaries):
# 10 x 20 x 24 x 4 B = 19.2 KB per BLS12-381 point, against a measured peak
# of 17.56 GiB for one 2^20 commit (18 KB per point) on an H100
_WORKSET_ARRAYS = 10
_WORKSET_WINDOWS = 20  # windows at the default window size for 2^18 - 2^24


def device_budget_bytes(device, hbm_budget_bytes: int | None = None) -> int:
    """The device-memory budget of the MSM engines: ``hbm_budget_bytes``,
    else ``msm_hbm_budget_bytes``, else the free memory the card reports
    plus what PyTorch's allocator holds unused (4 GiB on the CPU)."""
    if hbm_budget_bytes is None:
        hbm_budget_bytes = get_config().msm_hbm_budget_bytes
    if hbm_budget_bytes is None:
        dev = torch.device(device)
        if dev.type != "cuda":
            return 4 << 30
        cached = torch.cuda.memory_reserved(dev) - torch.cuda.memory_allocated(dev)
        with phase("wait/mem_get_info"):
            free = torch.cuda.mem_get_info(dev)[0]
        hbm_budget_bytes = free + cached
    return hbm_budget_bytes


def calc_chunk_size(spec: CurveSpec, device, hbm_budget_bytes: int | None = None) -> int:
    """Most points per MSM launch that fit the device-memory budget
    (``device_budget_bytes``): half of it goes to the engine's working set
    of ~_WORKSET_ARRAYS * W coordinate arrays per point."""
    L = spec.base.n_limbs * spec.ext
    per_point = _WORKSET_ARRAYS * _WORKSET_WINDOWS * L * 4
    n = (device_budget_bytes(device, hbm_budget_bytes) // 2) // per_point
    return max(1 << 12, 1 << (n.bit_length() - 1))  # round down to pow2


def _spill_rows(chunk: int, half: int) -> int:
    """Spill rows a chunk adds over all pair rounds: round r spills at most
    min(rows / 2^(r+1), C * (half + 1) + 1), i.e. about min(chunk /
    2^(r+1), half + 1) a chunk, and under one row a chunk in all rounds
    past log2(chunk)."""
    return sum(min(chunk >> (r + 1), half + 1) for r in range(max(1, (chunk - 1).bit_length()))) + 1


# int32 coordinate arrays of L words that live per row and window at a batch
# engine's peak: the pair engine's gathered (W, rows, 2L) rows, round 0's
# (W, rows / 2, 3L) output and their temporaries; the scan engine's gathered
# rows, its (W, n, 3L) Jacobian rows, their shifted copy and the round's
# output.  The pair engine also holds each spill row three times (3L words:
# the spill, the finish's concatenation and its sorted copy).
_SLAB_ARRAYS = {"pair": 6, "scan": 12}
_SPILL_ARRAYS = 9


def batch_slab(spec: CurveSpec, method: str, chunk: int, w: int, device,
               hbm_budget_bytes: int | None = None) -> int:
    """Most chunks of ``chunk`` points per slab of ``multiple_multiexp``
    (one engine call each) that fit half the device-memory budget
    (``device_budget_bytes``), with the real window count and the spill
    buffers counted; a power of two."""
    W = -(-SCALAR_BITS // w)
    L = spec.base.n_limbs * spec.ext
    words = _SLAB_ARRAYS[method] * chunk
    if method == "pair":
        words += _SPILL_ARRAYS * _spill_rows(chunk, 1 << (w - 1))
    c = (device_budget_bytes(device, hbm_budget_bytes) // 2) // (W * L * 4 * words)
    return 1 << max(0, c.bit_length() - 1)


def _auto(signed: bool) -> str:
    """The engine "auto" picks: the lattice for unsigned digits, else the
    pair engine, on G1 and G2 alike.  tpu_ec's (tpu_ec/ops/msm.py:393-405,
    515-522) runs G2 on the scan engine, whose ~log2(n) adds a point and
    window its pair engine avoids only on G1; the port's pair engine takes
    either coordinate width."""
    return "pair" if signed else "lattice"


class MultiexpKernel:
    """MSM entry point bound to one curve (G1 or G2) and device."""

    def __init__(self, spec: CurveSpec, device="cuda", maybe_abort=None,
                 chunk_size: int | None = None):
        self.spec = spec
        self.device = resolve_device(device)
        self.ops = PointOps(spec, self.device)
        self.maybe_abort = maybe_abort
        self.chunk_size = chunk_size or calc_chunk_size(spec, self.device)

    def _check_abort(self):
        if self.maybe_abort is not None and self.maybe_abort():
            raise Aborted("MSM aborted by hook")

    def multiexp(self, bases, scalars: torch.Tensor, *, window_size: int | None = None,
                 num_groups: int | None = None, signed: bool = True, method: str = "auto"):
        """sum_i scalars[i] * bases[i] -> one Jacobian point (batch (1,)).

        ``bases`` are affine (x, y) of (n, L) ((0, 0) = identity; L =
        ``PointOps.width``, 2 Fq elements a coordinate on G2); ``scalars``
        are (n, Ls) plain-integer limbs (not Montgomery; see
        ``PointOps.scalars_to_limbs``).  ``method``: "pair" (the
        pair-halving engine, which "auto" picks for signed digits), "coz"
        (the co-Z scaled-affine engine, G1 only), "scan" (the masked
        segmented-scan engine), "sorted" (the run-halving engine), all
        four on signed digits only, or
        "lattice" (the bucket lattice, signed or unsigned digits, which
        "auto" picks for ``signed=False``; ``num_groups`` G, else
        ``default_num_groups``; it runs whole, whatever ``chunk_size``, and
        takes ``window_size`` or ``default_window_size``, as tpu_ec's
        does).  The other engines take ``window_size``, else
        ``config.msm_window``, else the card's table (``tuned_window``),
        else the engine's model.  The call is the span "msm"
        (``utils/timer.py``), the engine's stages its children."""
        from .autotune import tuned_window
        from .msm_coz import default_window_size_coz, msm_coz
        from .msm_pair import default_window_size_pair, msm_pair
        from .msm_scan import default_window_size_scan, msm_scan
        from .msm_sorted import default_window_size_sorted, msm_sorted

        self._check_abort()
        if method == "auto":
            method = _auto(signed)
        n = bases[0].shape[0]
        if method == "lattice":
            w = window_size or default_window_size(n)
            G = num_groups or default_num_groups(n, w)
            if G < 1 or G & (G - 1):
                raise ValueError(f"num_groups must be a power of two (the groups' halving tree), got {G}")
            get_logger("tpu_ec_torch.msm").info(
                "MSM n=%d curve=%s engine=lattice window=%d groups=%d signed=%s", n, self.spec.name, w, G, signed
            )
            with phase("msm", curve=self.spec.name, n=n, engine="lattice", window=w, groups=G):
                points, s, _ = prepare_inputs(bases, scalars, G)
                return msm_lattice(self.ops, points, s, window_size=w, signed=signed)
        engines = {"pair": (msm_pair, default_window_size_pair),
                   "coz": (msm_coz, default_window_size_coz),
                   "scan": (msm_scan, default_window_size_scan),
                   "sorted": (msm_sorted, default_window_size_sorted)}
        if method not in engines:
            raise ValueError(f"unknown MSM method {method!r}")
        if not signed:
            raise ValueError(f"the {method} engine takes signed digits only; use method='lattice'")
        if n > self.chunk_size:
            with phase("msm", curve=self.spec.name, n=n, engine=method, chunk=self.chunk_size):
                return self._multiexp_chunked(bases, scalars, window_size, method)
        engine, default_w = engines[method]
        w = window_size or get_config().msm_window or tuned_window(self.spec.name, method, n) or default_w(n)
        get_logger("tpu_ec_torch.msm").info(
            "MSM n=%d curve=%s engine=%s window=%d", n, self.spec.name, method, w
        )
        with phase("msm", curve=self.spec.name, n=n, engine=method, window=w):
            s = torch.cat([scalars, scalars.new_zeros((n, 1))], dim=1)
            return engine(self.ops, bases, s, window_size=w)

    def _multiexp_chunked(self, bases, scalars, window_size, method):
        """Split an oversized MSM into chunk_size pieces and add the partial
        Jacobian results on the device."""
        n = bases[0].shape[0]
        c = self.chunk_size
        get_logger("tpu_ec_torch.msm").info(
            "MSM n=%d exceeds chunk_size=%d: %d chunks", n, c, -(-n // c)
        )
        acc = None
        for lo in range(0, n, c):
            self._check_abort()
            b = tuple(t[lo : lo + c] for t in bases)
            part = self.multiexp(b, scalars[lo : lo + c], window_size=window_size, method=method)
            acc = part if acc is None else self.ops.add(acc, part)
        return acc

    def multiple_multiexp(self, bases, scalars: torch.Tensor, num_chunks: int, *,
                          window_size: int | None = None, num_groups: int | None = None, signed: bool = True,
                          method: str = "auto"):
        """``num_chunks`` independent MSMs over equal slices of ``bases``
        (ag-cuda-ec/src/multiexp.rs:21-81: chunk c takes bases and scalar
        rows [c * n, (c + 1) * n)) -> a Jacobian batch of num_chunks points.

        ``method``: "pair" (the flat one-sort engine: the pair engine with a
        chunk axis, which "auto" picks for signed digits) or "scan" (the
        scan engine with a chunk axis) run the batch in slabs of chunks
        sized from the device memory (``batch_slab``); the window is ``window_size``, else the
        card's table at the chunk size (``tuned_window``), else the engine's
        model there (``config.msm_window`` is not read, as in tpu_ec).  Any
        other method, and "auto" with ``signed=False`` (the lattice), runs
        one ``multiexp`` per chunk."""
        n = bases[0].shape[0]
        if num_chunks <= 0 or n % num_chunks:
            raise ValueError(f"bases must split evenly into chunks: {n} points, {num_chunks} chunks")
        chunk = n // num_chunks
        if method == "auto":
            method = _auto(signed)
        if method not in ("pair", "scan"):
            with phase("msm_batch", curve=self.spec.name, n=chunk, batch=num_chunks, engine=method):
                outs = []
                for c in range(num_chunks):
                    self._check_abort()
                    sl = slice(c * chunk, (c + 1) * chunk)
                    outs.append(self.multiexp(tuple(t[sl] for t in bases), scalars[sl], window_size=window_size,
                                              num_groups=num_groups, signed=signed, method=method))
                with phase("msm_batch/cat"):
                    return tuple(torch.cat(parts) for parts in zip(*outs))
        if not signed:
            raise ValueError(f"the {method} engine takes signed digits only; use method='lattice'")
        from .autotune import tuned_window
        from .msm_pair import default_window_size_pair, msm_pair
        from .msm_scan import default_window_size_scan, msm_scan

        engine, default_w = {"pair": (msm_pair, default_window_size_pair),
                             "scan": (msm_scan, default_window_size_scan)}[method]
        w = window_size or tuned_window(self.spec.name, method, chunk) or default_w(chunk)
        with phase("msm_batch", curve=self.spec.name, n=chunk, batch=num_chunks, engine=method, window=w):
            with phase("msm_batch/slab_size"):
                slab = min(batch_slab(self.spec, method, chunk, w, self.device), num_chunks)
            get_logger("tpu_ec_torch.msm").info(
                "batch MSM %d chunks of %d curve=%s engine=%s window=%d slab=%d",
                num_chunks, chunk, self.spec.name, method, w, slab,
            )
            pts = tuple(t.reshape(num_chunks, chunk, -1) for t in bases)
            s = torch.cat([scalars, scalars.new_zeros((n, 1))], dim=1).reshape(num_chunks, chunk, -1)
            parts = []
            for lo in range(0, num_chunks, slab):
                self._check_abort()
                with phase("msm_batch/slab"):
                    p, sc = tuple(t[lo : lo + slab] for t in pts), s[lo : lo + slab]
                    pad = slab - sc.shape[0]
                    if pad:  # every slab has one shape: chunk 0's bases, zero scalars
                        p = tuple(torch.cat([c, t[:1].expand(pad, *t.shape[1:])]) for c, t in zip(p, pts))
                        sc = torch.cat([sc, sc.new_zeros((pad,) + sc.shape[1:])])
                    parts.append(engine(self.ops, p, sc, window_size=w))
            with phase("msm_batch/cat"):
                return tuple(torch.cat(c)[:num_chunks] for c in zip(*parts))

    def upload_bases(self, bases):
        """Pin an affine base table on the device, in the storage dtype, for
        reuse across calls (the SRS is uploaded once)."""
        return tuple(
            torch.as_tensor(t).to(device=self.device, dtype=self.ops.fq.dtype).contiguous()
            for t in bases
        )


# -- functional convenience ---------------------------------------------------


def msm(spec: CurveSpec, bases, scalars: torch.Tensor, *, device="cuda", **kw):
    """``MultiexpKernel(spec, device).multiexp(bases, scalars, **kw)``."""
    return MultiexpKernel(spec, device).multiexp(bases, scalars, **kw)


def multiexp_1bit(spec: CurveSpec, bases, scalars: torch.Tensor, num_groups: int | None = None, *,
                  device="cuda"):
    """The 1-bit-window MSM (``ag-build/cl/batch_multiexp.cl:11-55``): window
    1, unsigned digits, one bucket a scalar bit, on the lattice."""
    return MultiexpKernel(spec, device).multiexp(bases, scalars, window_size=1, signed=False, method="lattice",
                                                 num_groups=num_groups)
