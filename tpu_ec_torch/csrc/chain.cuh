// K3's chain entries: the Horner window combine of the MSM, the scalar
// multiplication [k] P, one EC-FFT stage and the bucket lattice's buckets
// and running sums, on the lane-tile field core (field_tile.cuh).
//
// Replace tpu_ec/ops/pallas/point.py:_point_call_list (K3, with point.cu's
// point_kernel for the batched point ops) where tpu_ec runs it in a chain:
// the Horner combine (tpu_ec/ops/msm_pair.py:horner_combine, and for a batch
// of MSMs tpu_ec/ops/msm_batch.py:horner_combine_batch: from the identity,
// w doublings and one add a window, top window first), one tile a chunk;
// PointOps.scalar_mul (tpu_ec/curves/point.py:334-351, 256 MSB-first
// double-and-add steps), one tile a point; and one Pease stage of
// tpu_ec/ops/ec_fft.py:_ec_fft_impl (u = a + b, v = [w^e](a - b)), one tile
// a butterfly.  The formulas are point.cu's (dbl-2009-l, add-2007-bl with
// the select tree of PointOps.add), the same products of the same operands,
// and every value is canonical where it is tested or stored, so the
// Jacobian outputs are bit-identical to tpu_ec's PointOps, not merely the
// same points.
//
// Bound on the H100: the latency of one chain.  A chain is a series of
// point ops (the commit's Horner ~270, an AMT chunk's ~300, a scalar
// multiplication up to ~510), ~10 field products each; the card's IMAD rate
// would run a 2^11 stage's 1024 chains in ~0.06 ms, but a chain takes its
// ops' product latencies in series: at best its levels of products (below)
// times one product's latency (tec_mul_chain measures that).
//
// Design.  A tile of lanes runs each chain (kTile = 4 on G1, kTile2 = 16
// on G2).  The formulas are written in levels of independent products (3 a
// doubling, 5 an add), and the lanes compute a level's products side by
// side, each with field.cuh's one-thread product (field_tile.cuh), so an
// op's critical path is its levels, not its products.  On G1 every lane
// holds every value (TileProducts); on G2 each half of the tile holds one
// component of every Fq2 value (TileProducts2); either way the lanes run
// the adds and subtracts themselves, and each branch (identity, P == Q,
// the scalar's bit, the chain's `same` flag) agrees across the tile.
// Tiles of consecutive butterflies share a warp, so from stage log2(32 /
// T) on (T the tile's lanes: stage 3 on G1, stage 1 on G2) the tiles of a
// warp hold one scalar and the warp does not diverge either; blocks of one
// warp spread a 2^11 stage, or an AMT slab's 1024 Horner chains, over the
// SMs.  The rare P == Q doubling of the stage's adds runs in a separate
// non-inlined function that reads P again; in the Horner and the scalar
// multiplication it is the chain's next doubling.
//
// The bucket lattice (lattice_kernel below) replaces the lattice's use of
// tpu_ec/ops/pallas/point.py:_point_call_list, driven by
// tpu_ec/ops/msm.py:_msm_lattice: m steps of gather, add_mixed and scatter
// over the (group, window) lanes, then the running-sum reduction's 2
// (nbuckets - 1) adds, each a launch of its own.  Each lane's work is one
// chain: its nonzero digits' mixed adds into its buckets in step order, from
// the identity, then the reduction over its buckets, so the kernel's bound
// is the busiest lane's product levels in series, not the card's IMAD rate
// (a G1 2^16 lattice has 5504 lanes).  One tile of lanes a (group, window)
// lane runs the whole chain in one launch: the buckets stay in a device
// table, each read and written back by the tile that owns it, and the
// running sums stay in registers.  Lanes are window-fastest, so the tiles of
// a warp share each step's point load.  A tile reads 32 steps' digits at
// once and walks only the nonzero ones, so tiles that skip a step do not
// hold their warp (multiexp_1bit: half the digits are 0).
//
// G1 and G2.  The formulas take the tile field as a type: TileProducts (Fq)
// for G1, TileProducts2 (Fq2: 3 Fq products an Fq2 product, so 16 lanes
// run a level of up to 4 in one round) for G2.  The G1 instances are
// chain.cu's; the G2 ones are g2_horner.cu's, g2_scalar_mul.cu's,
// g2_ec_fft_stage.cu's and g2_lattice.cu's, one compile each, so that the
// widest instances build side by side.
#pragma once

#include <type_traits>

#include "field_tile.cuh"

namespace {

using tec::Fe;
using tec::FieldConsts;

// The lanes of a G1 chain, for both word counts: the add's widest levels
// hold 4 products, and 4 lanes ran fastest of the sizes timed (PERF.md).
constexpr int kTile = 4;
// The lanes of a G2 chain: 16 run a level of up to 4 Fq2 products (the
// add's widest) in one round, and ran faster than 8 and 4 (PERF.md).
constexpr int kTile2 = 16;
constexpr int kChainThreads = 32;  // one warp a block: a chain is serial, so spread them over the SMs
constexpr int kScalarWords = 8;    // Fr of both curves: 256-bit plain scalars, 16 half-limbs

// The tile field at ext 1 (Fq, G1) or 2 (Fq2, G2).
template <int NW, int EXT>
using Field = typename std::conditional<EXT == 1, tec::TileProducts<NW, kTile>,
                                       tec::TileProducts2<NW, kTile2>>::type;

struct ChainArgs {
  const int32_t* in[6];  // X Y Z of P (the stage: of the input, then of its output again)
  long long in_stride[6];
  int32_t* out[3];
  long long out_stride;
  long long n;  // points or butterflies, one tile each
};

// A point operand read from device memory at each use: coordinates k,
// k + 1, k + 2 of the arguments at row i.
template <class Fd>
struct MemPoint {
  using E = typename Fd::E;
  const ChainArgs& a;
  const Fd& f;
  int k;
  long long i;
  __device__ __forceinline__ E at(int c) const { return f.load(a.in[k + c] + i * a.in_stride[k + c]); }
  __device__ __forceinline__ E X() const { return at(0); }
  __device__ __forceinline__ E Y() const { return at(1); }
  __device__ __forceinline__ E Z() const { return at(2); }
};

// -Q of a point operand read from device memory (PointOps.sub's neg).
template <class Fd>
struct NegMemPoint {
  using E = typename Fd::E;
  MemPoint<Fd> q;
  __device__ __forceinline__ E X() const { return q.X(); }
  __device__ __forceinline__ E Y() const { return q.f.neg(q.Y()); }
  __device__ __forceinline__ E Z() const { return q.Z(); }
};

// A point held in registers (the chain's accumulator).
template <class Fd>
struct RegPoint {
  using E = typename Fd::E;
  E x, y, z;
  __device__ __forceinline__ E X() const { return x; }
  __device__ __forceinline__ E Y() const { return y; }
  __device__ __forceinline__ E Z() const { return z; }
};

// Where an op's result goes, one canonical coordinate at a time: device
// memory (row i of the outputs) or registers.
template <class Fd>
struct MemOut {
  using E = typename Fd::E;
  const ChainArgs& a;
  const Fd& f;
  long long i;
  __device__ __forceinline__ void X(const E& v) const { f.store(a.out[0] + i * a.out_stride, v); }
  __device__ __forceinline__ void Y(const E& v) const { f.store(a.out[1] + i * a.out_stride, v); }
  __device__ __forceinline__ void Z(const E& v) const { f.store(a.out[2] + i * a.out_stride, v); }
};

template <class Fd>
struct RegOut {
  using E = typename Fd::E;
  RegPoint<Fd>& r;
  __device__ __forceinline__ void X(const E& v) const { r.x = v; }
  __device__ __forceinline__ void Y(const E& v) const { r.y = v; }
  __device__ __forceinline__ void Z(const E& v) const { r.z = v; }
};

// dbl-2009-l (ec.cl:17-42), point.cu's dbl in levels of independent
// products (3 levels for 7 products); identity-safe: Z3 = 2*Y*Z = 0.
template <class Fd, class Out>
__device__ __forceinline__ void dbl(const Fd& f, const typename Fd::E& X,
                                    const typename Fd::E& Y, const typename Fd::E& Z,
                                    const Out& out) {
  using E = typename Fd::E;
  E l1[3];  // Y Z, A = X^2, B = Y^2
  f.mul_many(l1, {Y, X, Y}, {Z, X, Y});
  const E& A = l1[1];
  const E& B = l1[2];
  out.Z(f.canon(f.dbl(l1[0])));
  const E XB = f.add(X, B);
  const E Ee = f.add(f.dbl(A), A);
  E l2[3];  // C = B^2, (X + B)^2, E^2
  f.mul_many(l2, {B, XB, Ee}, {B, XB, Ee});
  const E& C = l2[0];
  const E D = f.dbl(f.sub(f.sub(l2[1], A), C));
  const E X3 = f.canon(f.sub(l2[2], f.dbl(D)));
  const E eightC = f.dbl(f.dbl(f.dbl(C)));
  E l3[1];  // E (D - X3)
  f.mul_many(l3, {Ee}, {f.sub(D, X3)});
  out.Y(f.canon(f.sub(l3[0], eightC)));
  out.X(X3);
}

// add-2007-bl (ec.cl:85-120), point.cu's add_core in levels of independent
// products (5 levels for 16 products), with its select tree: P identity ->
// Q, else Q identity -> P, else P == Q -> returns false and leaves the
// doubling of P to the caller.  Z3 = 2 (Z1 Z2) H, as point.cu forms it; it
// and I = (2H)^2 are formed beside S1 and S2, before the P == Q test, and
// stored only after it.
template <class Fd, class SP, class SQ, class Out>
__device__ __forceinline__ bool add_core(const Fd& f, const SP& P, const SQ& Q, const Out& out) {
  using E = typename Fd::E;
  const E Z1 = P.Z();
  const E Z2 = Q.Z();
  if (f.is_zero(Z1)) {
    out.X(Q.X()); out.Y(Q.Y()); out.Z(Z2);
    return true;
  }
  if (f.is_zero(Z2)) {
    out.X(P.X()); out.Y(P.Y()); out.Z(Z1);
    return true;
  }
  E l1[3];  // Z1 Z2, Z2Z2, Z1Z1
  f.mul_many(l1, {Z1, Z2, Z1}, {Z2, Z2, Z1});
  E l2[4];  // Z2^3, U1 = X1 Z2Z2, Z1^3, U2 = X2 Z1Z1
  f.mul_many(l2, {Z2, P.X(), Z1, Q.X()}, {l1[1], l1[1], l1[2], l1[2]});
  const E& U1 = l2[1];
  const E H = f.canon(f.sub(l2[3], U1));
  const E H2 = f.dbl(H);
  E l3[4];  // S1 = Y1 Z2^3, S2 = Y2 Z1^3, Z3, I = (2H)^2
  f.mul_many(l3, {P.Y(), Q.Y(), f.dbl(l1[0]), H2}, {l2[0], l2[2], H, H2});
  const E& S1 = l3[0];
  const E rr = f.canon(f.dbl(f.sub(l3[1], S1)));
  if (f.is_zero(H) && f.is_zero(rr)) return false;
  out.Z(f.canon(l3[2]));
  E l4[3];  // rr^2, J = H I, V = U1 I
  f.mul_many(l4, {rr, H, U1}, {rr, l3[3], l3[3]});
  const E X3 = f.canon(f.sub(f.sub(l4[0], l4[1]), f.dbl(l4[2])));
  E l5[2];  // rr (V - X3), S1 J
  f.mul_many(l5, {rr, S1}, {f.sub(l4[2], X3), l4[1]});
  out.Y(f.canon(f.sub(l5[0], f.dbl(l5[1]))));
  out.X(X3);
  return true;
}

// madd-2007-bl (ec.cl:45-82), point.cuh's add_mixed_core in levels of
// independent products (5 levels for 11 products), with its select tree:
// P identity -> A lifted (z = 1, or 0 where A is (0, 0)), else A identity
// -> P, else P == A -> returns false and leaves the doubling of P to the
// caller.  A = (ax, ay) affine; Z3 = 2 Z1 H, as point.cuh forms it.  P's
// coordinates are read before the first store, so out may be P's own row.
template <class Fd, class SP, class Out>
__device__ __forceinline__ bool add_mixed_core(const Fd& f, const SP& P, const typename Fd::E& ax,
                                               const typename Fd::E& ay, const Out& out) {
  using E = typename Fd::E;
  const E Z1 = P.Z();
  const bool i2 = f.is_zero(ax) && f.is_zero(ay);
  if (f.is_zero(Z1)) {
    out.X(ax); out.Y(ay); out.Z(i2 ? f.zero() : f.one());
    return true;
  }
  if (i2) {
    out.X(P.X()); out.Y(P.Y()); out.Z(Z1);
    return true;
  }
  E l1[1];  // Z1Z1
  f.mul_many(l1, {Z1}, {Z1});
  E l2[2];  // U2 = x2 Z1Z1, Z1^3
  f.mul_many(l2, {ax, Z1}, {l1[0], l1[0]});
  const E X1 = P.X();
  const E H = f.canon(f.sub(l2[0], X1));
  const E Y1 = P.Y();
  E l3[3];  // S2 = y2 Z1^3, Z1 H, H^2
  f.mul_many(l3, {ay, Z1, H}, {l2[1], H, H});
  const E rr = f.canon(f.dbl(f.sub(l3[0], Y1)));
  if (f.is_zero(H) && f.is_zero(rr)) return false;
  out.Z(f.canon(f.dbl(l3[1])));
  const E I = f.dbl(f.dbl(l3[2]));
  E l4[3];  // rr^2, J = H I, V = X1 I
  f.mul_many(l4, {rr, H, X1}, {rr, I, I});
  const E X3 = f.canon(f.sub(f.sub(l4[0], l4[1]), f.dbl(l4[2])));
  E l5[2];  // rr (V - X3), Y1 J
  f.mul_many(l5, {rr, Y1}, {f.sub(l4[2], X3), l4[1]});
  out.Y(f.canon(f.sub(l5[0], f.dbl(l5[1]))));
  out.X(X3);
  return true;
}

// The P == Q rows of the stage's adds and of the lattice's mixed adds:
// rare, so kept out of the kernels' code.  Row i of coordinates k.. is read
// again; the result goes to row o.
template <class Fd>
__device__ __noinline__ void double_to(const ChainArgs* a, int k, long long i, long long o, const FieldConsts* fc) {
  const Fd f(*fc);
  const MemPoint<Fd> P{*a, f, k, i};
  dbl<Fd>(f, P.X(), P.Y(), P.Z(), MemOut<Fd>{*a, f, o});
}

// Bit b of a 256-bit scalar held in registers (a select over the words, so
// that k stays in registers under a run-time b).
__device__ __forceinline__ uint32_t scalar_bit(const Fe<kScalarWords>& k, int b) {
  uint32_t w = 0;
#pragma unroll
  for (int i = 0; i < kScalarWords; ++i) w = (b >> 5) == i ? k.w[i] : w;
  return (w >> (b & 31)) & 1u;
}

// acc = [k] P, MSB first from the identity: acc = 2 acc, then acc = acc + P
// where the bit is set (PointOps.add, falling back to 2 acc where acc == P).
// Two shortcuts leave every coordinate as tpu_ec's 256 steps give it: the
// steps above k's top set bit are skipped (the double of (0, 0, 0) is
// (0, 0, 0), and (0, 0, 0) + P is P itself), and so are the adds of the zero
// bits (tpu_ec selects acc there).  One call site of dbl serves both the
// step's doubling and the rare acc == P fallback.  Every lane holds all of
// k, so the bit tests agree across the tile.
template <class Fd, class SP>
__device__ __forceinline__ void scalar_chain(const Fd& f, const SP& P, const Fe<kScalarWords>& k,
                                             RegPoint<Fd>& acc) {
  int top = -1;
#pragma unroll
  for (int i = 0; i < kScalarWords; ++i)
    if (k.w[i]) top = 32 * i + 31 - __clz(k.w[i]);
  if (top < 0) {
    acc = RegPoint<Fd>{f.zero(), f.zero(), f.zero()};
    return;
  }
  acc = RegPoint<Fd>{P.X(), P.Y(), P.Z()};
  RegPoint<Fd> t;
  const RegOut<Fd> to{t};
  bool same = false;  // the last add found acc == P: this doubling is its result
#pragma unroll 1
  for (int b = top - 1; b >= 0;) {
    dbl<Fd>(f, acc.x, acc.y, acc.z, to);
    acc = t;
    if (same) {
      same = false;
      --b;
      continue;
    }
    if (scalar_bit(k, b)) {
      if (!add_core<Fd>(f, acc, P, to)) {
        same = true;
        continue;
      }
      acc = t;
    }
    --b;
  }
}

// The Horner combine, one tile a chunk c (args.n chunks): from the all-zero
// identity, for j = windows-1 .. 0, res = 2^w res (w doublings), then res =
// res + S_jc (PointOps.add, falling back to 2 res where res == S_jc), in
// tpu_ec's order.  S: in[0..2] with row strides, row j * n + c.  While res
// is all zero its doublings are skipped: the double of (0, 0, 0) is (0, 0,
// 0), so every coordinate stays as tpu_ec's combine gives it.  One call
// site of dbl serves the doublings and the rare res == S_jc fallback.
template <class Fd>
__global__ void __launch_bounds__(kChainThreads)
    horner_kernel(const __grid_constant__ ChainArgs args, int windows, int w, const __grid_constant__ FieldConsts fc) {
  const long long c = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / Fd::kLanes;
  if (c >= args.n) return;  // the whole tile
  const Fd f(fc);
  RegPoint<Fd> res{f.zero(), f.zero(), f.zero()};
  RegPoint<Fd> t;
  const RegOut<Fd> to{t};
  int left = 0;       // doublings left before window j's add
  bool same = false;  // the last add found res == S_jc: this doubling is its result
#pragma unroll 1
  for (int j = windows - 1; j >= 0;) {
    if (left > 0 || same) {
      dbl<Fd>(f, res.x, res.y, res.z, to);
      res = t;
      if (!same) {
        --left;
        continue;
      }
      same = false;
    } else {
      if (!add_core<Fd>(f, res, MemPoint<Fd>{args, f, 0, j * args.n + c}, to)) {
        same = true;
        continue;
      }
      res = t;
    }
    --j;  // window j is in: the next one's doublings, unless res is all zero
    left = f.is_zero(res.x) && f.is_zero(res.y) && f.is_zero(res.z) ? 0 : w;
  }
  const MemOut<Fd> out{args, f, c};
  out.X(res.x); out.Y(res.y); out.Z(res.z);
}

// One tile a point i: out_i = [k_i] P_i.  P: in[0..2] with row strides, k:
// 16 half-limbs a row with row stride k_stride (0: one scalar for all).
template <class Fd>
__global__ void __launch_bounds__(kChainThreads)
    scalar_mul_kernel(const __grid_constant__ ChainArgs args, const int32_t* k, long long k_stride,
                      const __grid_constant__ FieldConsts fc) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / Fd::kLanes;
  if (i >= args.n) return;  // the whole tile
  const Fd f(fc);
  RegPoint<Fd> acc;
  scalar_chain<Fd>(f, MemPoint<Fd>{args, f, 0, i}, tec::load_fe<kScalarWords>(k + i * k_stride), acc);
  const MemOut<Fd> out{args, f, i};
  out.X(acc.x); out.Y(acc.y); out.Z(acc.z);
}

// One Pease stage s over a batch of transforms of 2 * half points each
// (tpu_ec/ops/ec_fft.py:_ec_fft_impl): butterfly g = t * half + i, one tile
// (args.n = batches * half of them, consecutive in a warp), reads a = row
// t * 2half + i and b = row t * 2half + half + i of in[0..2], writes u = a + b
// to output row t * 2half + 2i and v = [tw_e](a - b), e = (i >> s) << s, to
// the next row.  in[3..5] are the outputs again: the chain reads a - b back
// from v's row, where it is stored first.
template <class Fd>
__global__ void __launch_bounds__(kChainThreads)
    ec_fft_stage_kernel(const __grid_constant__ ChainArgs args, const int32_t* tw, long long half, int s,
                        const __grid_constant__ FieldConsts fc) {
  const long long g = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / Fd::kLanes;
  if (g >= args.n) return;  // the whole tile
  const Fd f(fc);
  const long long t = g / half, i = g - t * half;
  const long long ia = 2 * t * half + i, ib = ia + half, ou = 2 * t * half + 2 * i, ov = ou + 1;
  const MemPoint<Fd> A{args, f, 0, ia};
  if (!add_core<Fd>(f, A, MemPoint<Fd>{args, f, 0, ib}, MemOut<Fd>{args, f, ou}))
    double_to<Fd>(&args, 0, ia, ou, &fc);
  if (!add_core<Fd>(f, A, NegMemPoint<Fd>{MemPoint<Fd>{args, f, 0, ib}}, MemOut<Fd>{args, f, ov}))
    double_to<Fd>(&args, 0, ia, ov, &fc);
  RegPoint<Fd> acc;
  scalar_chain<Fd>(f, MemPoint<Fd>{args, f, 3, ov},
                   tec::load_fe<kScalarWords>(tw + ((i >> s) << s) * 2 * kScalarWords), acc);
  const MemOut<Fd> out{args, f, ov};
  out.X(acc.x); out.Y(acc.y); out.Z(acc.z);
}

// The bucket lattice's operands.  b: the bucket table, ((nbuckets - 1)
// lanes) fused rows X | Y | Z (in[0..2] and out[0..2] the same three
// columns, row stride 3 ext L), slot k >= 1 of lane l at row (k - 1) lanes
// + l; x, y: the (m G) affine point rows of the steps, step t group g at
// row t G + g; digits: (m, lanes) int32, lane l = g W + j (window j of
// group g); sum: the (lanes) output rows, contiguous.
struct LatticeArgs {
  ChainArgs b;
  const int32_t* x;
  const int32_t* y;
  long long x_stride, y_stride;
  const int32_t* digits;
  int32_t* sum[3];
  long long sum_stride;
  long long lanes;
  int m, windows, nbuckets;
};

// A point operand of the reduction: bucket row `row`, read from device
// memory at each use, or the running sum where acc takes it.
template <class Fd>
struct SlotOrRunning {
  using E = typename Fd::E;
  const ChainArgs& a;
  const Fd& f;
  long long row;
  const RegPoint<Fd>& running;
  bool reg;
  __device__ __forceinline__ E at(int c, const E& r) const {
    return reg ? r : f.load(a.in[c] + row * a.in_stride[c]);
  }
  __device__ __forceinline__ E X() const { return at(0, running.x); }
  __device__ __forceinline__ E Y() const { return at(1, running.y); }
  __device__ __forceinline__ E Z() const { return at(2, running.z); }
};

constexpr int kScan = 32;  // steps whose digits a tile reads at once

// One tile a (group, window) lane (args.lanes of them): tpu_ec's
// _msm_lattice for that lane.  For t = 0 .. m - 1 with digit d != 0, bucket
// |d| = bucket |d| + (x, y) of step t's point of the lane's group, y negated
// where d < 0 (PointOps.add_mixed, falling back to the bucket's doubling
// where they are equal), each bucket read and stored back canonical by
// its tile: the tile syncs between its lanes' reads and their stores, and
// every lane later reads what it stored itself.  A zero digit is skipped
// (tpu_ec adds into the dummy slot 0, which nothing reads).  Then the
// running sum in registers, for k = nbuckets - 1 .. 1: running = running +
// bucket k; acc = acc + running (PointOps.add, falling back to the doubling
// of the left operand where they are equal), in tpu_ec's order; acc goes to
// the lane's sum row.  Digits: each lane of the tile reads K steps of a run
// of kScan, the tile ORs its nonzero bits into one mask and walks its set
// bits, taking each digit from the lane that read it.
template <class Fd>
__global__ void __launch_bounds__(kChainThreads)
    lattice_kernel(const __grid_constant__ LatticeArgs a, const __grid_constant__ FieldConsts fc) {
  using E = typename Fd::E;
  constexpr int T = Fd::kLanes, K = kScan / T;
  static_assert(kScan % T == 0, "a run of steps is whole per lane");
  const long long lane = ((long long)blockIdx.x * blockDim.x + threadIdx.x) / T;
  if (lane >= a.lanes) return;  // the whole tile
  const Fd f(fc);
  const int r = (int)f.tile.thread_rank();
  const long long G = a.lanes / a.windows, g = lane / a.windows;
#pragma unroll 1
  for (int t0 = 0; t0 < a.m; t0 += kScan) {
    int dig[K];
    uint32_t mask = 0;
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const int t = t0 + k * T + r;
      dig[k] = t < a.m ? a.digits[(long long)t * a.lanes + lane] : 0;
      mask |= (uint32_t)(dig[k] != 0) << (k * T + r);
    }
#pragma unroll
    for (int s = 1; s < T; s <<= 1) mask |= f.tile.shfl_xor(mask, s);
#pragma unroll 1
    while (mask) {
      const int b = __ffs(mask) - 1;
      mask &= mask - 1;
      int own = dig[0];
#pragma unroll
      for (int k = 1; k < K; ++k) own = b / T == k ? dig[k] : own;
      const int d = f.tile.shfl(own, b % T);
      const long long row = (long long)((d < 0 ? -d : d) - 1) * a.lanes + lane;
      const long long pt = (long long)(t0 + b) * G + g;
      const MemPoint<Fd> B{a.b, f, 0, row};
      const RegPoint<Fd> P{B.X(), B.Y(), B.Z()};
      const E ay = f.load(a.y + pt * a.y_stride);
      f.tile.sync();  // every lane has read the bucket before any lane stores it
      if (!add_mixed_core<Fd>(f, P, f.load(a.x + pt * a.x_stride), d < 0 ? f.neg(ay) : ay,
                              MemOut<Fd>{a.b, f, row}))
        double_to<Fd>(&a.b, 0, row, row, &fc);
    }
  }
  RegPoint<Fd> running{f.zero(), f.zero(), f.zero()}, acc = running, t;
  const RegOut<Fd> to{t};
  bool same = false;  // the last add found P == Q: this step's result is the doubling of P
  // step j = 2 (nbuckets - 1) - 1 .. 0: odd, running + bucket (j >> 1) + 1;
  // even, acc + running
#pragma unroll 1
  for (int j = 2 * (a.nbuckets - 1) - 1; j >= 0;) {
    const bool into_acc = (j & 1) == 0;
    const RegPoint<Fd> P = into_acc ? acc : running;
    if (same) {
      dbl<Fd>(f, P.x, P.y, P.z, to);
      same = false;
    } else if (!add_core<Fd>(f, P, SlotOrRunning<Fd>{a.b, f, (long long)(j >> 1) * a.lanes + lane, running, into_acc},
                             to)) {
      same = true;
      continue;
    }
    if (into_acc) {
      acc = t;
    } else {
      running = t;
    }
    --j;
  }
  f.store(a.sum[0] + lane * a.sum_stride, acc.x);
  f.store(a.sum[1] + lane * a.sum_stride, acc.y);
  f.store(a.sum[2] + lane * a.sum_stride, acc.z);
}

ChainArgs make_args(const void* const* in, const long long* in_stride, int n_in, void* const* out,
                    long long out_stride, long long n) {
  ChainArgs a;
  for (int k = 0; k < 6; ++k) {
    a.in[k] = k < n_in ? (const int32_t*)in[k] : nullptr;
    a.in_stride[k] = k < n_in ? in_stride[k] : 0;
  }
  for (int k = 0; k < 3; ++k) a.out[k] = (int32_t*)out[k];
  a.out_stride = out_stride;
  a.n = n;
  return a;
}

// Threads and blocks for n tiles of Fd's lanes, kChainThreads a block.
template <class Fd>
void geometry(long long n, unsigned& blocks, int& threads) {
  const long long lanes = n * Fd::kLanes;
  threads = lanes < kChainThreads ? (int)lanes : kChainThreads;
  blocks = (unsigned)((lanes + threads - 1) / threads);
}

template <class Fd>
int launch_horner(const ChainArgs& a, int windows, int w, const FieldConsts& c, cudaStream_t s) {
  unsigned blocks;
  int threads;
  geometry<Fd>(a.n, blocks, threads);
  horner_kernel<Fd><<<blocks, threads, 0, s>>>(a, windows, w, c);
  return (int)cudaGetLastError();
}

template <class Fd>
int launch_scalar_mul(const ChainArgs& a, const int32_t* k, long long k_stride, const FieldConsts& c,
                      cudaStream_t s) {
  unsigned blocks;
  int threads;
  geometry<Fd>(a.n, blocks, threads);
  scalar_mul_kernel<Fd><<<blocks, threads, 0, s>>>(a, k, k_stride, c);
  return (int)cudaGetLastError();
}

template <class Fd>
int launch_stage(const ChainArgs& a, const int32_t* tw, long long half, int stage, const FieldConsts& c,
                 cudaStream_t s) {
  unsigned blocks;
  int threads;
  geometry<Fd>(a.n, blocks, threads);
  ec_fft_stage_kernel<Fd><<<blocks, threads, 0, s>>>(a, tw, half, stage, c);
  return (int)cudaGetLastError();
}

template <class Fd>
int launch_lattice(const LatticeArgs& a, const FieldConsts& c, cudaStream_t s) {
  unsigned blocks;
  int threads;
  geometry<Fd>(a.lanes, blocks, threads);
  lattice_kernel<Fd><<<blocks, threads, 0, s>>>(a, c);
  return (int)cudaGetLastError();
}

// The entries' work at ext EXT.  In each, nw is the 32-bit words of Fq (8
// or 12): a coordinate row holds 2 * nw * EXT int32 half-limbs.

// The Horner window combine of `chunks` MSMs side by side: in = 3 device
// pointers of the (windows * chunks) per-window sums (X, Y, Z), row
// j * chunks + c for window j of chunk c, with row strides; out = 3 device
// pointers of (chunks) contiguous rows.  One tile a chunk.
template <int EXT>
int horner_entry(int nw, const void* const* in, const long long* in_stride, int windows, long long chunks, int w,
                 void* const* out, const uint32_t* fc, void* stream) {
  if (windows <= 0 || chunks <= 0 || w < 0) return (int)cudaErrorInvalidValue;
  const ChainArgs a = make_args(in, in_stride, 3, out, 2LL * EXT * nw, chunks);
  const FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return launch_horner<Field<8, EXT>>(a, windows, w, c, s);
  if (nw == 12) return launch_horner<Field<12, EXT>>(a, windows, w, c, s);
  return (int)cudaErrorInvalidValue;
}

// [k_i] P_i for n points: in = 3 device pointers of (n) coordinate rows
// with row strides (0: one point for all), k = (n, 16) int32 plain
// half-limbs with row stride k_stride (0: one scalar for all), out = 3
// device pointers of (n) contiguous rows, not overlapping the inputs.  One
// tile a point.
template <int EXT>
int scalar_mul_entry(int nw, const void* const* in, const long long* in_stride, const void* k, long long k_stride,
                     void* const* out, long long n, const uint32_t* fc, void* stream) {
  if (n <= 0) return 0;
  const ChainArgs a = make_args(in, in_stride, 3, out, 2LL * EXT * nw, n);
  const FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return launch_scalar_mul<Field<8, EXT>>(a, (const int32_t*)k, k_stride, c, s);
  if (nw == 12) return launch_scalar_mul<Field<12, EXT>>(a, (const int32_t*)k, k_stride, c, s);
  return (int)cudaErrorInvalidValue;
}

// Stage s of `batches` EC-FFTs of 2^log_n points side by side: in = 3 device
// pointers of (batches * 2^log_n) coordinate rows with row stride
// in_stride, transform t at rows [t 2^log_n, (t + 1) 2^log_n); out = 3 device
// pointers of the same shape, contiguous, not overlapping the inputs; tw =
// the (2^(log_n - 1), 16) contiguous int32 plain twiddle scalars w^j.  One
// tile a butterfly.
template <int EXT>
int stage_entry(int nw, const void* const* in, long long in_stride, void* const* out, const void* tw,
                long long batches, int log_n, int stage, const uint32_t* fc, void* stream) {
  if (log_n < 1 || stage < 0 || stage >= log_n || batches < 0) return (int)cudaErrorInvalidValue;
  const long long half = 1LL << (log_n - 1), n = batches * half;
  if (n == 0) return 0;
  const void* ins[6] = {in[0], in[1], in[2], out[0], out[1], out[2]};
  const long long row = 2LL * EXT * nw;
  const long long strides[6] = {in_stride, in_stride, in_stride, row, row, row};
  const ChainArgs a = make_args(ins, strides, 6, out, row, n);
  const FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return launch_stage<Field<8, EXT>>(a, (const int32_t*)tw, half, stage, c, s);
  if (nw == 12) return launch_stage<Field<12, EXT>>(a, (const int32_t*)tw, half, stage, c, s);
  return (int)cudaErrorInvalidValue;
}

// The bucket lattice's per-lane sums of one MSM: x, y = device pointers of
// the (m groups) affine point rows (step-major) with row strides; digits =
// the (m, groups windows) contiguous int32 window digits (lane g windows + j
// for window j of group g), |d| < nbuckets; table = ((nbuckets - 1) groups
// windows, 3 * 2 * EXT * nw) contiguous int32, all zero (the identity), the
// buckets, left holding them; sums = 3 device pointers of (groups windows)
// contiguous rows, sum_k k bucket_k of each lane.  One tile a lane.
template <int EXT>
int lattice_entry(int nw, const void* x, long long x_stride, const void* y, long long y_stride, const void* digits,
                  int m, long long groups, int windows, int nbuckets, void* table, void* const* sums,
                  const uint32_t* fc, void* stream) {
  if (m < 0 || groups <= 0 || windows <= 0 || nbuckets < 2) return (int)cudaErrorInvalidValue;
  const long long L = 2LL * EXT * nw;
  int32_t* tb = (int32_t*)table;
  const void* cols[3] = {tb, tb + L, tb + 2 * L};
  const long long strides[3] = {3 * L, 3 * L, 3 * L};
  void* outs[3] = {tb, tb + L, tb + 2 * L};
  LatticeArgs a;
  a.b = make_args(cols, strides, 3, outs, 3 * L, groups * windows);
  a.x = (const int32_t*)x;
  a.y = (const int32_t*)y;
  a.x_stride = x_stride;
  a.y_stride = y_stride;
  a.digits = (const int32_t*)digits;
  for (int k = 0; k < 3; ++k) a.sum[k] = (int32_t*)sums[k];
  a.sum_stride = L;
  a.lanes = groups * windows;
  a.m = m;
  a.windows = windows;
  a.nbuckets = nbuckets;
  const FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return launch_lattice<Field<8, EXT>>(a, c, s);
  if (nw == 12) return launch_lattice<Field<12, EXT>>(a, c, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace
