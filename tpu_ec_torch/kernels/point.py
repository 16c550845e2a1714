"""K3: batched Jacobian point ops (add, add_mixed, double), and their plain version.

Replaces ``tpu_ec/ops/pallas/point.py::_point_call_list`` / ``_point_call``
(entries ``jac_add``, ``jac_add_mixed``, ``jac_double``), and runs in one
launch each: the MSM's Horner window combine
(``tpu_ec/ops/msm_pair.py::horner_combine``, and for a batch of MSMs
``tpu_ec/ops/msm_batch.py::horner_combine_batch``, one tile of lanes a
chunk), the scalar multiplication chain of
``tpu_ec/curves/point.py::PointOps.scalar_mul`` (one tile a point), one
stage of the EC-group FFT (``tpu_ec/ops/ec_fft.py::_ec_fft_impl``, one tile
a butterfly) and the bucket lattice's accumulation and running-sum
reduction (``tpu_ec/ops/msm.py::_msm_lattice``, one tile a (group, window)
lane).  The kernels are ``csrc/point.cuh`` for the batched ops and
``csrc/chain.cuh`` for the four chains, where a tile of lanes runs each
chain and computes each level of a point op's independent products side by
side (``csrc/field_tile.cuh``).  The plain version below evaluates the same
formulas with the same select tree as ``tpu_ec/ops/pallas/point.py`` (it
computes the doubling branch only on the rows that select it), so both are
bit-identical to ``tpu_ec``'s PointOps.

Every entry takes ``ext``: 1 for G1 (coordinates (..., L) in Fq), 2 for G2
(coordinates (..., 2L) in Fq2, c0 then c1).  tpu_ec runs G2 on its jnp
formulas only (no Pallas kernel); the port runs it on Fq2 kernels of its
own (the ``csrc/g2_*.cu`` units, C entries named with "_fp2"): the batched
ops on two lanes a row (``csrc/g2_point.cu``), the chains on a tile of 16
lanes (``chain_tile(spec, 2)``), counted apart from the G1 launches.  A G2
call on the card launches them or raises, like any other.
"""

from __future__ import annotations

import ctypes

import torch

from ..fields.limbs import add_plain, const_tensor, sub_plain
from ..fields.params import FieldSpec
from .build import Launches, check, check_cuda, field_consts, load, row_views, stream
from .mont import mont_mul_plain

LAUNCHES = Launches("point")  # every G1 K3 launch, those of the entries below too
HORNER_LAUNCHES = Launches("point_horner")  # the Horner entry's launches
CHAIN_LAUNCHES = Launches("point_scalar_mul")  # the scalar-multiplication chain's
STAGE_LAUNCHES = Launches("ec_fft_stage")  # the EC-FFT stage entry's
LATTICE_LAUNCHES = Launches("point_lattice")  # the bucket lattice entry's
MUL_CHAIN_LAUNCHES = Launches("mul_chain")  # the chains' latency yardstick (on no path)
# the Fq2 (G2) instances, the same five counts
LAUNCHES_FP2 = Launches("point_fp2")
HORNER_LAUNCHES_FP2 = Launches("point_horner_fp2")
CHAIN_LAUNCHES_FP2 = Launches("point_scalar_mul_fp2")
STAGE_LAUNCHES_FP2 = Launches("ec_fft_stage_fp2")
LATTICE_LAUNCHES_FP2 = Launches("point_lattice_fp2")
_COUNTS = {1: (LAUNCHES, HORNER_LAUNCHES, CHAIN_LAUNCHES, STAGE_LAUNCHES, LATTICE_LAUNCHES),
           2: (LAUNCHES_FP2, HORNER_LAUNCHES_FP2, CHAIN_LAUNCHES_FP2, STAGE_LAUNCHES_FP2, LATTICE_LAUNCHES_FP2)}

SCALAR_LIMBS = 16  # plain Fr scalars of both curves: 256 bits, the chain's length

OPS = {"add": 0, "add_mixed": 1, "double": 2}
N_IN = {"add": (6,), "add_mixed": (5, 4), "double": (3,)}


def _count(ext: int, entry: int = -1) -> None:
    """One launch of K3 at ``ext``: every launch counts once in the ext's
    total, an entry's (0 Horner, 1 chain, 2 stage, 3 lattice) also in its
    own."""
    counts = _COUNTS[ext]
    counts[0].count += 1
    if entry >= 0:
        counts[1 + entry].count += 1


def _entry(lib: ctypes.CDLL, name: str, ext: int):
    """K3's C entry ``name`` at ``ext``: the G1 instance, or its Fq2 twin
    (``name`` + "_fp2", the ``csrc/g2_*.cu`` units)."""
    return getattr(lib, name if ext == 1 else name + "_fp2")


def _width(spec: FieldSpec, ext: int) -> int:
    """Half-limbs of one coordinate at ``ext`` (1: Fq, 2: Fq2)."""
    if ext not in (1, 2):
        raise ValueError(f"ext must be 1 (G1) or 2 (G2), got {ext}")
    return ext * spec.n_limbs


class _PlainField:
    """The field ops the formulas use, on int64 half-limbs, any device."""

    def __init__(self, spec: FieldSpec, device):
        self.spec = spec
        self.one = const_tensor(spec.one_limbs, device)

    def add(self, a, b):
        return add_plain(self.spec, a, b)

    def sub(self, a, b):
        return sub_plain(self.spec, a, b)

    def neg(self, a):
        return sub_plain(self.spec, torch.zeros_like(a), a)

    def mul(self, a, b):
        return mont_mul_plain(self.spec, a, b)

    def mul_many(self, *pairs) -> tuple:
        """The products a * b of independent pairs, as one batched product
        where every operand has one shape (the cost of a plain product on a
        small batch is its count of tensor ops, not its rows)."""
        shape = pairs[0][0].shape
        if len(pairs) == 1 or any(t.shape != shape for pair in pairs for t in pair):
            return tuple(self.mul(a, b) for a, b in pairs)
        a = torch.stack([a for a, _ in pairs])
        b = torch.stack([b for _, b in pairs])
        return tuple(mont_mul_plain(self.spec, a, b).unbind(0))

    def double(self, a):
        return add_plain(self.spec, a, a)

    @staticmethod
    def is_zero(a):
        return (a == 0).all(dim=-1)

    @staticmethod
    def select(cond, a, b):
        return torch.where(cond.unsqueeze(-1), a, b)


class _PlainField2(_PlainField):
    """The same ops on Fq2 elements, (..., 2L) int64 half-limbs (c0, c1),
    u^2 = -1: tpu_ec's Fp2Ops, its product the 3-product Karatsuba."""

    def __init__(self, spec: FieldSpec, device):
        self.base = _PlainField(spec, device)
        self.spec = spec
        self.L = spec.n_limbs
        self.one = torch.cat([self.base.one, torch.zeros_like(self.base.one)])

    def _on_parts(self, fn, *xs):
        parts = [x.reshape(*x.shape[:-1], 2, self.L) for x in xs]
        r = fn(self.spec, *parts)
        return r.reshape(*r.shape[:-2], 2 * self.L)

    def add(self, a, b):
        return self._on_parts(add_plain, a, b)

    def sub(self, a, b):
        return self._on_parts(sub_plain, a, b)

    def neg(self, a):
        return self._on_parts(sub_plain, torch.zeros_like(a), a)

    def double(self, a):
        return self.add(a, a)

    def mul_many(self, *pairs) -> tuple:
        """The Fq2 products a * b of independent pairs: their 3 Fq products
        each (a0 b0, a1 b1, (a0 + a1)(b0 + b1)) as one batched base call."""
        L, F = self.L, self.base
        ops = []
        for a, b in pairs:
            a0, a1, b0, b1 = a[..., :L], a[..., L:], b[..., :L], b[..., L:]
            ops += [(a0, b0), (a1, b1), (F.add(a0, a1), F.add(b0, b1))]
        prods = F.mul_many(*ops)
        out = []
        for k in range(len(pairs)):
            aa, bb, o = prods[3 * k : 3 * k + 3]
            out.append(torch.cat([F.sub(aa, bb), F.sub(F.sub(o, aa), bb)], dim=-1))
        return tuple(out)


def _plain_field(spec: FieldSpec, ext: int, device) -> _PlainField:
    return _PlainField(spec, device) if ext == 1 else _PlainField2(spec, device)


def _double_body(F, X, Y, Z):
    """dbl-2009-l (ec.cl:17-42); identity-safe (Z3 = 2YZ = 0).  The
    independent products of each step go in one batched call."""
    A, B, YZ = F.mul_many((X, X), (Y, Y), (Y, Z))
    E = F.add(F.double(A), A)
    XB = F.add(X, B)
    C, XB2, FF = F.mul_many((B, B), (XB, XB), (E, E))
    D = F.double(F.sub(F.sub(XB2, A), C))
    X3 = F.sub(FF, F.double(D))
    eightC = F.double(F.double(F.double(C)))
    (EDX,) = F.mul_many((E, F.sub(D, X3)))
    return X3, F.sub(EDX, eightC), F.double(YZ)


def _double_where(F, cond, X, Y, Z):
    """dbl-2009-l of the rows where ``cond`` holds, zeros elsewhere: the
    select tree takes the doubling on those rows only, so the plain version
    computes it there only."""
    out = (torch.zeros_like(X), torch.zeros_like(Y), torch.zeros_like(Z))
    if bool(cond.any()):
        idx = cond.nonzero(as_tuple=True)
        for o, d in zip(out, _double_body(F, X[idx], Y[idx], Z[idx])):
            o[idx] = d
    return out


def _add_body(F, X1, Y1, Z1, X2, Y2, Z2):
    """add-2007-bl with the select completeness of PointOps.add (the
    independent products of each step in one batched call)."""
    Z12 = F.add(Z1, Z2)
    Z1Z1, Z2Z2, Z12sq = F.mul_many((Z1, Z1), (Z2, Z2), (Z12, Z12))
    U1, U2, Z2c, Z1c = F.mul_many((X1, Z2Z2), (X2, Z1Z1), (Z2, Z2Z2), (Z1, Z1Z1))
    H = F.sub(U2, U1)
    H2 = F.double(H)
    S1, S2, I, Z3 = F.mul_many((Y1, Z2c), (Y2, Z1c), (H2, H2), (F.sub(F.sub(Z12sq, Z1Z1), Z2Z2), H))
    rr = F.double(F.sub(S2, S1))
    J, V, rr2 = F.mul_many((H, I), (U1, I), (rr, rr))
    X3 = F.sub(F.sub(rr2, J), F.double(V))
    rVX, S1J = F.mul_many((rr, F.sub(V, X3)), (S1, J))
    Y3 = F.sub(rVX, F.double(S1J))
    i1, i2 = F.is_zero(Z1), F.is_zero(Z2)
    same = (~i1) & (~i2) & F.is_zero(H) & F.is_zero(rr)
    dX, dY, dZ = _double_where(F, same, X1, Y1, Z1)
    out = []
    for r, d, a, b in ((X3, dX, X1, X2), (Y3, dY, Y1, Y2), (Z3, dZ, Z1, Z2)):
        r = F.select(same, d, r)
        r = F.select(i2, a, r)
        out.append(F.select(i1, b, r))
    return tuple(out)


def _add_mixed_body(F, X1, Y1, Z1, X2, Y2):
    """madd-2007-bl (ec.cl:45-82) with select completeness; (X2, Y2) affine,
    (0, 0) = identity (the independent products of each step in one
    batched call)."""
    (Z1Z1,) = F.mul_many((Z1, Z1))
    U2, Z1c = F.mul_many((X2, Z1Z1), (Z1, Z1Z1))
    H = F.sub(U2, X1)
    Z1H = F.add(Z1, H)
    S2, HH, Z1H2 = F.mul_many((Y2, Z1c), (H, H), (Z1H, Z1H))
    I = F.double(F.double(HH))
    rr = F.double(F.sub(S2, Y1))
    J, V, rr2 = F.mul_many((H, I), (X1, I), (rr, rr))
    X3 = F.sub(F.sub(rr2, J), F.double(V))
    rVX, Y1J = F.mul_many((rr, F.sub(V, X3)), (Y1, J))
    Y3 = F.sub(rVX, F.double(Y1J))
    Z3 = F.sub(F.sub(Z1H2, Z1Z1), HH)
    i1 = F.is_zero(Z1)
    i2 = F.is_zero(X2) & F.is_zero(Y2)
    same = (~i1) & (~i2) & F.is_zero(H) & F.is_zero(rr)
    dX, dY, dZ = _double_where(F, same, X1, Y1, Z1)
    zq = F.select(i2, torch.zeros_like(Z1), F.one.expand_as(Z1))  # affine -> jacobian z
    out = []
    for r, d, a, b in ((X3, dX, X1, X2), (Y3, dY, Y1, Y2), (Z3, dZ, Z1, zq)):
        r = F.select(same, d, r)
        r = F.select(i2, a, r)
        out.append(F.select(i1, b, r))
    return tuple(out)


_BODIES = {"add": _add_body, "add_mixed": _add_mixed_body, "double": _double_body}


def _check(spec: FieldSpec, op: str, coords, keep, out, ext: int) -> None:
    """Raise unless the arguments fit the op (before any device work)."""
    if len(coords) not in N_IN[op]:
        raise ValueError(f"{op}: expected {' or '.join(map(str, N_IN[op]))} coordinates, got {len(coords)}")
    batch = tuple(coords[0].shape[:-1])
    if keep is not None:
        if op == "double":
            raise ValueError("double takes no keep mask")
        if keep.dtype != torch.bool or tuple(keep.shape) != batch or keep.device != coords[0].device:
            raise ValueError(f"keep: expected bool {batch} on {coords[0].device}, got "
                             f"{keep.dtype} {tuple(keep.shape)} on {keep.device}")
    if out is not None:
        want = batch + (3 * _width(spec, ext),)
        if tuple(out.shape) != want or out.dtype != coords[0].dtype or out.device != coords[0].device:
            raise ValueError(f"out: expected {coords[0].dtype} {want} on {coords[0].device}, got "
                             f"{out.dtype} {tuple(out.shape)} on {out.device}")


def _split(out: torch.Tensor, L: int) -> tuple:
    return tuple(out[..., k * L : (k + 1) * L] for k in range(3))


def point_op_plain(spec: FieldSpec, op: str, coords, keep=None, ext: int = 1) -> tuple:
    """Plain PyTorch version on any device: ``coords`` are the op's inputs
    as (..., ext L) tensors; returns (X3, Y3, Z3) in the inputs' dtype.  An
    add_mixed with 4 coordinates takes P affine and lifts it (z = 1, or 0
    for (0, 0)); ``keep`` (bool, the batch shape) selects P over the sum."""
    F = _plain_field(spec, ext, coords[0].device)
    c = [t.to(torch.int64) for t in coords]
    if op == "add_mixed" and len(c) == 4:
        ident = F.is_zero(c[0]) & F.is_zero(c[1])
        c.insert(2, F.select(ident, torch.zeros_like(c[0]), F.one.expand_as(c[0])))
    res = _BODIES[op](F, *c)
    if keep is not None:
        res = tuple(F.select(keep, p, r) for p, r in zip(c[:3], res))
    return tuple(r.to(coords[0].dtype) for r in res)


def point_op(spec: FieldSpec, op: str, coords, *, keep=None, out=None, ext: int = 1) -> tuple:
    """One batched group op: ``op`` in add (P, Q Jacobian: 6 coordinates),
    add_mixed (P Jacobian and A affine: 5; or P affine, lifted: 4) or
    double (P: 3), over Fq (``ext`` 1, coordinates (..., L)) or Fq2 (2,
    (..., 2L)).

    ``keep`` (add, add_mixed): a bool tensor of the batch shape; where set,
    the result is P (lifted) instead of the sum, i.e. ``where(keep, P, P +
    Q)``.  ``out``: a (..., 3 ext L) tensor that receives (X3, Y3, Z3) side by
    side (the fused rows of the MSM); it must not overlap the inputs, and
    the result is then its three column slices.

    CPU tensors take the plain version.  On CUDA the coordinates are int32
    (..., ext L) tensors of one shape whose last axis is contiguous (row
    strides are passed to the kernel, so column slices of a fused row matrix
    need no copy); the kernel computes the op on the current stream."""
    L = _width(spec, ext)
    _check(spec, op, coords, keep, out, ext)
    if coords[0].device.type == "cpu":
        res = point_op_plain(spec, op, coords, keep, ext)
        if out is None:
            return res
        for k, r in enumerate(res):
            out[..., k * L : (k + 1) * L] = r
        return _split(out, L)
    shape = coords[0].shape
    flat = row_views(op, coords, L)
    n = flat[0].shape[0]
    if out is None:
        outs = [torch.empty((n, L), dtype=torch.int32, device=coords[0].device) for _ in range(3)]
        out_ptrs, out_stride = [o.data_ptr() for o in outs], L
    else:
        rows = out.view(n, 3 * L)  # raises where the rows are no view
        if rows.stride(-1) != 1:
            raise ValueError("out: the last axis must be contiguous")
        out_ptrs = [rows.data_ptr() + 4 * k * L for k in range(3)]
        out_stride = rows.stride(0)
    if len(flat) == 4:  # add_mixed with P affine: no z
        flat.insert(2, None)
    keep_flat = None if keep is None else keep.reshape(-1).contiguous()
    ins = (ctypes.c_void_p * 6)(*[None if f is None else f.data_ptr() for f in flat])
    strides = (ctypes.c_longlong * 6)(*[0 if f is None else f.stride(0) for f in flat])
    lib = load()
    err = _entry(lib, "tec_point", ext)(
        OPS[op], spec.n_limbs // 2, ins, strides, None if keep_flat is None else keep_flat.data_ptr(),
        (ctypes.c_void_p * 3)(*out_ptrs), out_stride, n, field_consts(spec), stream(),
    )
    check(lib, err, f"point {op}")
    _count(ext)
    if out is not None:
        return _split(out, L)
    return tuple(o.reshape(shape) for o in outs)


def _chunk_axis(partials) -> list:
    """Horner partials (W, L) or (W, C, L) -> (W, C, L) views (C = 1 for a
    single MSM; L here a coordinate's half-limbs)."""
    if partials[0].dim() not in (2, 3):
        raise ValueError(f"horner: partials must be (W, L) or (W, C, L), got {tuple(partials[0].shape)}")
    return [c if c.dim() == 3 else c.unsqueeze(1) for c in partials]


def horner_plain(spec: FieldSpec, partials, w: int, ext: int = 1) -> tuple:
    """Plain version of the Horner window combine: from the identity,
    res = 2^w * res + S_j for j = W-1 .. 0 (tpu_ec/ops/msm_pair.py::
    horner_combine; for a batch of C MSMs, all chunks advancing together,
    tpu_ec/ops/msm_batch.py::horner_combine_batch), one batched op at a
    time.  ``partials``: (W, L) coordinates, or (W, C, L) for C chunks;
    returns (1, L), or (C, L), coordinates."""
    S = _chunk_axis(partials)
    W = S[0].shape[0]
    res = tuple(torch.zeros_like(c[0]) for c in S)
    for j in range(W):
        for _ in range(w):
            res = point_op_plain(spec, "double", list(res), ext=ext)
        res = point_op_plain(spec, "add", [*res, *(c[W - 1 - j] for c in S)], ext=ext)
    return res


def horner(spec: FieldSpec, partials, w: int, ext: int = 1) -> tuple:
    """The Horner window combine of the MSM, or of C MSMs side by side, in
    one kernel launch (one tile of lanes a chunk, on the point ops'
    formulas, so bit-identical to :func:`horner_plain`).  ``partials``: the
    (W, L) per-window sums (X, Y, Z), or (W, C, L) for C chunks, int32 with
    contiguous last axes on CUDA (row strides go to the kernel); returns
    (1, L), or (C, L), coordinates (L: ext times the field's half-limbs).
    CPU tensors take the plain version."""
    if w < 0:
        raise ValueError(f"horner: window size must be >= 0, got {w}")
    L = _width(spec, ext)
    if partials[0].device.type == "cpu":
        return horner_plain(spec, partials, w, ext)
    S = _chunk_axis(partials)
    W, C = S[0].shape[:2]
    flat = row_views("horner", S, L)  # row j * C + c: window j of chunk c
    outs = [torch.empty((C, L), dtype=torch.int32, device=partials[0].device) for _ in range(3)]
    lib = load()
    err = _entry(lib, "tec_point_horner", ext)(
        spec.n_limbs // 2, (ctypes.c_void_p * 3)(*[f.data_ptr() for f in flat]),
        (ctypes.c_longlong * 3)(*[f.stride(0) for f in flat]), W, C, w,
        (ctypes.c_void_p * 3)(*[o.data_ptr() for o in outs]), field_consts(spec), stream(),
    )
    check(lib, err, "point horner")
    _count(ext, 0)
    return tuple(outs)


def scalar_mul_plain(spec: FieldSpec, coords, k: torch.Tensor, ext: int = 1) -> tuple:
    """Plain version of the chain: PointOps.scalar_mul as tpu_ec runs it
    (tpu_ec/curves/point.py:334-351), MSB first from the identity over the
    256 bits, acc = double(acc), then acc = add(acc, P) where the bit is
    set, one batched op at a time.  The steps above the batch's top set bit
    (acc is (0, 0, 0) there, and so is its double) and the adds of a bit no
    row has set (the select keeps acc) are skipped.  ``coords``: P's (X, Y,
    Z), (..., L); ``k``: (..., 16) plain scalar limbs that broadcast
    against P's batch.  Returns (X, Y, Z) in the inputs' dtype."""
    P = [c.to(torch.int64) for c in coords]
    kk = k.to(torch.int64).expand(P[0].shape[:-1] + (k.shape[-1],))
    acc = [torch.zeros_like(c) for c in P]
    flat = kk.reshape(-1, kk.shape[-1])
    limbs = (flat != 0).any(dim=0).nonzero()
    if limbs.numel():
        j = int(limbs[-1])
        top = 16 * j + int(flat[:, j].max()).bit_length() - 1
        for b in range(top, -1, -1):
            if b != top:
                acc = list(point_op_plain(spec, "double", acc, ext=ext))
            bit = ((kk[..., b // 16] >> (b % 16)) & 1) != 0
            if bool(bit.any()):
                acc = list(point_op_plain(spec, "add", [*acc, *P], keep=~bit, ext=ext))
    return tuple(a.to(coords[0].dtype) for a in acc)


def point_scalar_mul(spec: FieldSpec, coords, k: torch.Tensor, ext: int = 1) -> tuple:
    """[k] P for a batch of Jacobian points, in one kernel launch (one tile
    of lanes a point runs the whole chain; bit-identical to
    :func:`scalar_mul_plain`).  ``coords``: P's (X, Y, Z), (..., L); ``k``:
    (..., 16) plain (non-Montgomery) scalar limbs that broadcast against P's
    batch (a single scalar goes to the kernel with row stride 0).  CPU
    tensors take the plain version; on CUDA everything is int32 and the
    kernel runs on the current stream.  Returns (X, Y, Z), (..., L), L: ext
    times the field's half-limbs."""
    if k.shape[-1] != SCALAR_LIMBS or k.device != coords[0].device:
        raise ValueError(f"scalars: expected (..., {SCALAR_LIMBS}) half-limbs on {coords[0].device}, got "
                         f"{tuple(k.shape)} on {k.device}")
    L = _width(spec, ext)
    if coords[0].device.type == "cpu":
        return scalar_mul_plain(spec, coords, k, ext)
    shape = coords[0].shape
    flat = row_views("point scalar_mul", coords, L)
    n = flat[0].shape[0]
    if k.dtype != torch.int32:
        raise ValueError(f"scalars: expected int32, got {k.dtype}")
    kk = k.expand(shape[:-1] + (SCALAR_LIMBS,)).reshape(-1, SCALAR_LIMBS)
    if kk.stride(-1) != 1:
        kk = kk.contiguous()
    outs = [torch.empty((n, L), dtype=torch.int32, device=coords[0].device) for _ in range(3)]
    if n:
        lib = load()
        err = _entry(lib, "tec_point_scalar_mul", ext)(
            spec.n_limbs // 2, (ctypes.c_void_p * 3)(*[f.data_ptr() for f in flat]),
            (ctypes.c_longlong * 3)(*[f.stride(0) for f in flat]), kk.data_ptr(), kk.stride(0),
            (ctypes.c_void_p * 3)(*[o.data_ptr() for o in outs]), n, field_consts(spec), stream(),
        )
        check(lib, err, "point scalar_mul")
        _count(ext, 1)
    return tuple(o.reshape(shape) for o in outs)


def _lattice_shape(x, y, digits, nbuckets: int) -> tuple[int, int, int]:
    """(m, G, W) of a lattice's operands; raises where they do not fit."""
    if x.dim() != 3 or y.shape != x.shape or x.device != y.device:
        raise ValueError(f"lattice: x, y must be two (m, G, L) tensors on one device, got {tuple(x.shape)}, "
                         f"{tuple(y.shape)}")
    m, G = x.shape[:2]
    if digits.dim() != 2 or digits.shape[0] != m or G == 0 or digits.shape[1] % G or digits.device != x.device:
        raise ValueError(f"lattice: digits must be (m, G W) = ({m}, {G} W) on {x.device}, got "
                         f"{tuple(digits.shape)} on {digits.device}")
    if nbuckets < 2:
        raise ValueError(f"lattice: nbuckets must be >= 2, got {nbuckets}")
    return m, G, digits.shape[1] // G


def lattice_buckets_plain(spec: FieldSpec, x, y, digits, nbuckets: int, signed: bool, ext: int = 1) -> torch.Tensor:
    """The buckets of the bucket lattice (tpu_ec/ops/msm.py::_msm_lattice's
    accumulation): step t adds the affine point (x[t, g], y[t, g]) of each
    group g, y negated where a signed digit is negative, into slot |d| of
    each of its (g, j) lanes, d the digit of window j, with K3's add_mixed
    formulas and select tree; a lane whose digit is 0 keeps its buckets (tpu_ec
    adds into slot 0, which nothing reads).  One batched op a step.  ``x``,
    ``y``: (m, G, L) (L: ext times the field's half-limbs); ``digits``: (m,
    G W) window digits, lane g W + j; returns the (nbuckets, G, W, 3 L)
    fused buckets X | Y | Z, slot 0 all zero."""
    m, G, W = _lattice_shape(x, y, digits, nbuckets)
    L, GW = _width(spec, ext), G * W
    rows = digits.abs().long() * GW + torch.arange(GW, device=digits.device)
    idle = digits == 0
    if signed:
        y_neg = _plain_field(spec, ext, y.device).neg(y.to(torch.int64)).to(y.dtype)
        negative = (digits < 0).reshape(m, G, W, 1)
    buckets = x.new_zeros((nbuckets * GW, 3 * L))
    for t in range(m):
        cur = buckets[rows[t]]
        ax = x[t].unsqueeze(1).expand(G, W, L)
        ay = y[t].unsqueeze(1).expand(G, W, L)
        if signed:
            ay = torch.where(negative[t], y_neg[t].unsqueeze(1), ay)
        new = point_op_plain(spec, "add_mixed", [*_split(cur, L), ax.reshape(GW, L), ay.reshape(GW, L)], idle[t], ext)
        buckets[rows[t]] = torch.cat(new, dim=-1)
    return buckets.reshape(nbuckets, G, W, 3 * L)


def lattice_lanes_plain(spec: FieldSpec, x, y, digits, nbuckets: int, signed: bool, ext: int = 1) -> tuple:
    """Plain version of the bucket lattice's per-lane work: the buckets of
    :func:`lattice_buckets_plain`, then tpu_ec's running-sum reduction
    (multiexp.cl:121-131), for k = nbuckets - 1 .. 1: running = running +
    bucket k; acc = acc + running, from the identity, one batched K3 add at a
    time.  Returns acc = sum_k k bucket_k of each lane, (G, W, L) (X, Y, Z)."""
    slots = lattice_buckets_plain(spec, x, y, digits, nbuckets, signed, ext)
    L = _width(spec, ext)
    running = acc = tuple(torch.zeros_like(c) for c in _split(slots[0], L))
    for k in range(nbuckets - 1, 0, -1):
        running = point_op_plain(spec, "add", [*running, *_split(slots[k], L)], ext=ext)
        acc = point_op_plain(spec, "add", [*acc, *running], ext=ext)
    return acc


def lattice_lanes(spec: FieldSpec, x, y, digits, nbuckets: int, signed: bool, ext: int = 1) -> tuple:
    """The bucket lattice's per-lane work in one kernel launch (one tile of
    lanes a (group, window) lane runs its buckets' mixed adds in step order
    and then their running sum; bit-identical to :func:`lattice_lanes_plain`).
    ``x``, ``y``: the (m, G, L) affine points of the steps; ``digits``: (m,
    G W) window digits (``ops.msm.make_digits``), |d| < ``nbuckets``, signed
    or not; returns (G, W, L) (X, Y, Z), sum_k k bucket_k of each lane.  CPU
    tensors take the plain version; on CUDA everything is int32 (the points'
    last axis contiguous, the digits contiguous) and the kernel runs on the
    current stream, its bucket table a zeroed scratch tensor."""
    m, G, W = _lattice_shape(x, y, digits, nbuckets)
    L = _width(spec, ext)
    if x.device.type == "cpu":
        return lattice_lanes_plain(spec, x, y, digits, nbuckets, signed, ext)
    flat = row_views("point lattice", (x, y), L)
    check_cuda(digits, "lattice digits", torch.int32)
    table = torch.zeros(((nbuckets - 1) * G * W, 3 * L), dtype=torch.int32, device=x.device)
    outs = [torch.empty((G * W, L), dtype=torch.int32, device=x.device) for _ in range(3)]
    lib = load()
    err = _entry(lib, "tec_point_lattice", ext)(
        spec.n_limbs // 2, flat[0].data_ptr(), flat[0].stride(0), flat[1].data_ptr(), flat[1].stride(0),
        digits.data_ptr(), m, G, W, nbuckets, table.data_ptr(), (ctypes.c_void_p * 3)(*[o.data_ptr() for o in outs]),
        field_consts(spec), stream(),
    )
    check(lib, err, "point lattice")
    _count(ext, 3)
    return tuple(o.reshape(G, W, L) for o in outs)


def chain_tile(spec: FieldSpec, ext: int = 1) -> int:
    """The lanes of one chain of the chain entries (:func:`horner`,
    :func:`point_scalar_mul`, :func:`ec_fft_stage`, :func:`lattice_lanes`)
    over ``spec`` at ``ext``, fixed in ``csrc/chain.cuh``; builds the kernels
    on first call."""
    _width(spec, ext)
    return load().tec_chain_tile(spec.n_limbs // 2, ext)


def mul_chain_plain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, steps: int) -> torch.Tensor:
    """Plain version of :func:`mul_chain`: a b^steps R^-steps, one canonical
    (L,) element, by ``steps`` Montgomery products."""
    x = a.to(torch.int64)
    for _ in range(steps):
        x = mont_mul_plain(spec, x, b.to(torch.int64))
    return x.to(a.dtype)


def mul_chain(spec: FieldSpec, a: torch.Tensor, b: torch.Tensor, steps: int) -> torch.Tensor:
    """``steps`` field products in series on one thread of the card, x = x b
    from x = a (``csrc/chain.cu``, field.cuh's one-thread product): its time
    over ``steps`` is one product's latency, the unit of the chains' serial
    bound.  ``a``, ``b``: one canonical (L,) element each.  CPU tensors take
    the plain version."""
    if steps < 0:
        raise ValueError(f"mul_chain: steps must be >= 0, got {steps}")
    if a.device.type == "cpu":
        return mul_chain_plain(spec, a, b, steps)
    L = spec.n_limbs
    for name, t in (("a", a), ("b", b)):
        check_cuda(t, f"mul_chain {name}", torch.int32, (L,))
    out = torch.empty(L, dtype=torch.int32, device=a.device)
    lib = load()
    check(lib, lib.tec_mul_chain(L // 2, a.data_ptr(), b.data_ptr(), steps, out.data_ptr(), field_consts(spec),
                                 stream()), "mul_chain")
    MUL_CHAIN_LAUNCHES.count += 1
    return out


def _stage_log_n(coords, tw: torch.Tensor, s: int) -> int:
    n = coords[0].shape[-2] if coords[0].dim() >= 2 else 0
    log_n = n.bit_length() - 1
    if n < 2 or n != 1 << log_n:
        raise ValueError(f"ec_fft_stage: the transform axis (-2) must be a power of two >= 2, got {n}")
    if tuple(tw.shape) != (n // 2, SCALAR_LIMBS) or tw.device != coords[0].device:
        raise ValueError(f"ec_fft_stage: twiddles must be ({n // 2}, {SCALAR_LIMBS}) on {coords[0].device}, "
                         f"got {tuple(tw.shape)} on {tw.device}")
    if not 0 <= s < log_n:
        raise ValueError(f"ec_fft_stage: stage {s} outside [0, {log_n})")
    return log_n


def ec_fft_stage_plain(spec: FieldSpec, coords, tw: torch.Tensor, s: int, ext: int = 1) -> tuple:
    """Plain version of one EC-FFT stage (tpu_ec/ops/ec_fft.py:_ec_fft_impl):
    along axis -2 of (..., n, L), a = rows [0, n/2), b = rows [n/2, n);
    u = a + b, v = [tw_e](a - b) with e = (i >> s) << s (PointOps.add, sub
    and :func:`scalar_mul_plain`); out[2i] = u, out[2i + 1] = v.  ``tw``:
    the (n/2, 16) plain twiddle scalars."""
    P = [c.to(torch.int64) for c in coords]
    n = P[0].shape[-2]
    h = n // 2
    a = [c[..., :h, :] for c in P]
    b = [c[..., h:, :] for c in P]
    u = point_op_plain(spec, "add", [*a, *b], ext=ext)
    d = point_op_plain(spec, "add", [*a, b[0], _plain_field(spec, ext, b[1].device).neg(b[1]), b[2]], ext=ext)
    e = (torch.arange(h, device=tw.device) >> s) << s
    v = scalar_mul_plain(spec, d, tw[e], ext)
    return tuple(torch.stack([x, y], dim=-2).reshape(x.shape[:-2] + (n, x.shape[-1])).to(coords[0].dtype)
                 for x, y in zip(u, v))


def ec_fft_stage(spec: FieldSpec, coords, tw: torch.Tensor, s: int, ext: int = 1) -> tuple:
    """Stage ``s`` of the EC-group FFT for every transform of a batch, in one
    kernel launch (one tile of lanes a butterfly; bit-identical to
    :func:`ec_fft_stage_plain`).  ``coords``: (X, Y, Z) of shape (..., n,
    L), the transforms along axis -2; ``tw``: the (n/2, 16) plain twiddle
    scalars w^j.  The outputs are new tensors, never the inputs.  CPU
    tensors take the plain version; on CUDA everything is int32 and the
    kernel runs on the current stream."""
    log_n = _stage_log_n(coords, tw, s)
    L = _width(spec, ext)
    if coords[0].device.type == "cpu":
        return ec_fft_stage_plain(spec, coords, tw, s, ext)
    shape = coords[0].shape
    flat = row_views("ec_fft_stage", coords, L)
    if len({f.stride(0) for f in flat}) != 1:
        flat = [f.contiguous() for f in flat]
    check_cuda(tw, "twiddles", torch.int32)
    outs = [torch.empty((flat[0].shape[0], L), dtype=torch.int32, device=coords[0].device) for _ in range(3)]
    batches = flat[0].shape[0] >> log_n
    if batches:
        lib = load()
        err = _entry(lib, "tec_ec_fft_stage", ext)(
            spec.n_limbs // 2, (ctypes.c_void_p * 3)(*[f.data_ptr() for f in flat]), flat[0].stride(0),
            (ctypes.c_void_p * 3)(*[o.data_ptr() for o in outs]), tw.data_ptr(), batches, log_n, s,
            field_consts(spec), stream(),
        )
        check(lib, err, "ec_fft_stage")
        _count(ext, 2)
    return tuple(o.reshape(shape) for o in outs)
