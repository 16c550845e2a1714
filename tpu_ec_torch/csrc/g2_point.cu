// K3's batched point ops on G2 (coordinates in Fq2, c0 then c1): add-2007-bl,
// madd-2007-bl and dbl-2009-l with point.cuh's select tree (identity, P ==
// Q, P == -Q), on two lanes a row.
//
// Replaces tpu_ec/ops/pallas/point.py:_point_call_list for the G2 work the
// port sends to K3 (tpu_ec runs G2 on its jnp formulas, through no Pallas
// kernel).  The formulas are point.cuh's, the same products of the same
// operands, and every value is canonical where it is tested or stored, so
// the Jacobian outputs are bit-identical to tpu_ec's G2 PointOps.  Fq2 =
// Fq[u]/(u^2 + 1) on both curves; an element is (c0, c1), in device memory
// 2 * 2NW int32 half-limbs, c0 then c1.  Values stay in field.cuh's lazy
// domain [0, 2p): every sum or difference that feeds a product is a lazy
// add or subtract, and a product of two values below 2p is below 2p.
//
// Bound on the H100: integer-ALU, as the G1 kernel.  An add is 12 Fq2
// products and 4 squares, 44 Fq products of about 600 IMADs each for
// BLS12-381 (tpu_ec's form of Z3 takes 43), against 9 * 192 bytes of
// half-limb traffic.
//
// Design.  Two lanes a row, one Fq2 component a lane: the even lane holds
// c0 of every Fq2 value of the row, the odd lane c1, so a lane's state is
// the G1 kernel's (one Fq element a value), within __launch_bounds__(128,
// 4): at most 128 registers, 16 warps an SM, and a lane's straight-line
// code holds 22 Fq products, not 44.  An Fq2 product is 3 Fq products: a0
// b0 on the even lane and a1 b1 on the odd one side by side, and (a0 +
// a1)(b0 + b1) on one lane.  The formulas take their products two
// independent ones at a time (Pair2::mul2), so that the even lane computes
// the third product of the first and the odd lane that of the second, side
// by side: 3 rounds of one Fq product a lane for 2 Fq2 products.  A square
// is one round: (a0 + a1)(a0 - a1) on the even lane, a0 a1 (doubled) on
// the odd one.  A lane receives its partner's component of an operand or a
// product by NW shuffles (5 NW a pair of products, 1 NW a square), a few
// percent of the products' IMADs.  A zero test combines both lanes' flags,
// so the two lanes of a row take the same branch (every shuffle names the
// row's two lanes only; rows of one warp may branch apart).  The rare P ==
// Q doubling of the adds runs in a separate non-inlined function that
// reads P again.
#include <cooperative_groups.h>

#include "field.cuh"
#include "point_args.cuh"

namespace {

namespace cg = cooperative_groups;
using tec::Fe;
using tec::FieldConsts;

// Blocks of kThreads an SM that the launch bounds ask for: 4, <= 128
// registers.  At 12 words the adds spill ~0.6 KB there, and still ran
// faster than at 2 or 3 blocks (PERF.md).
constexpr int kPairBlocks = 4;

// The Fq2 field on the two lanes of a row: E is this lane's component of
// an Fq2 value (c0 on the even lane, c1 on the odd), lazy in [0, 2p).
template <int NW>
struct Pair2 {
  using E = Fe<NW>;

  cg::thread_block_tile<2> pair;
  const FieldConsts& fc;
  bool odd;  // this lane holds c1

  __device__ __forceinline__ Pair2(const FieldConsts& c)
      : pair(cg::tiled_partition<2>(cg::this_thread_block())), fc(c), odd(pair.thread_rank() == 1) {}

  // the partner lane's component of the value each lane passes
  __device__ __forceinline__ E other(const E& a) const {
    E r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = pair.shfl_xor(a.w[i], 1);
    return r;
  }

  static __device__ __forceinline__ E pick(bool take, const E& a, const E& b) {
    E r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = take ? a.w[i] : b.w[i];
    return r;
  }

  __device__ __forceinline__ E add(const E& a, const E& b) const { return tec::fe_add_lazy<NW>(a, b, fc); }
  __device__ __forceinline__ E sub(const E& a, const E& b) const { return tec::fe_sub_lazy<NW>(a, b, fc); }
  __device__ __forceinline__ E dbl(const E& a) const { return tec::fe_dbl_lazy<NW>(a, fc); }
  __device__ __forceinline__ E canon(const E& a) const { return tec::fe_canon<NW>(a, fc); }
  static __device__ __forceinline__ E zero() { return tec::fe_zero<NW>(); }
  // 1 = (R mod p, 0)
  __device__ __forceinline__ E one() const { return odd ? zero() : tec::fe_const<NW>(fc.one); }

  // The Fq2 value is zero: both lanes' components, so both lanes agree.
  __device__ __forceinline__ bool is_zero(const E& a) const {
    const int z = tec::fe_is_zero<NW>(a);
    return (z & pair.shfl_xor(z, 1)) != 0;
  }

  // a^2: c0 = (a0 + a1)(a0 - a1) on the even lane, c1 = 2 a0 a1 on the odd.
  __device__ __forceinline__ E sqr(const E& a) const {
    const E ao = other(a);
    const E p = tec::mul_eo<NW>(pick(odd, a, add(a, ao)), pick(odd, ao, sub(a, ao)), fc);
    return pick(odd, dbl(p), p);
  }

  // r1 = a b and r2 = c d, independent: round 1 a0 b0 | a1 b1, round 2 c0
  // d0 | c1 d1, round 3 (a0 + a1)(b0 + b1) on the even lane | (c0 + c1)(d0 +
  // d1) on the odd; then c0 = aa - bb on the even lane, c1 = o - aa - bb on
  // the odd.  The third products come first, so that a, b, c, d die early.
  __device__ __forceinline__ void mul2(E& r1, E& r2, const E& a, const E& b, const E& c, const E& d) const {
    const E rx = other(pick(odd, a, c)), ry = other(pick(odd, b, d));
    const E o = tec::mul_eo<NW>(add(pick(odd, c, a), rx), add(pick(odd, d, b), ry), fc);
    const E p1 = tec::mul_eo<NW>(a, b, fc);
    const E p2 = tec::mul_eo<NW>(c, d, fc);
    const E q1 = other(p1), q2 = other(p2), oo = other(o);
    r1 = sub(pick(odd, sub(oo, q1), p1), pick(odd, p1, q1));
    r2 = sub(pick(odd, sub(o, q2), p2), pick(odd, p2, q2));
  }
};

// A point operand read from device memory at each use, this lane's
// component: coordinates k, k + 1, k + 2 of the kernel's arguments at row
// i.  A null z pointer: an affine point (x, y) lifted to Jacobian, z = 1 or
// 0 for (0, 0).
template <int NW>
struct MemPoint2 {
  using E = Fe<NW>;
  const PointArgs& a;
  const Pair2<NW>& f;
  int k;
  long long i;
  __device__ __forceinline__ E at(int c) const {
    return tec::load_fe<NW>(a.in[k + c] + i * a.in_stride[k + c] + (f.odd ? 2 * NW : 0));
  }
  __device__ __forceinline__ E X() const { return at(0); }
  __device__ __forceinline__ E Y() const { return at(1); }
  __device__ __forceinline__ E Z() const {
    if (a.in[k + 2]) return at(2);
    return f.is_zero(X()) && f.is_zero(Y()) ? f.zero() : f.one();
  }
};

// Where an op's result goes, this lane's component of one canonical
// coordinate at a time.
template <int NW>
struct MemOut2 {
  using E = Fe<NW>;
  const PointArgs& a;
  const Pair2<NW>& f;
  long long i;
  __device__ __forceinline__ void put(int c, const E& v) const {
    tec::store_fe<NW>(a.out[c] + i * a.out_stride + (f.odd ? 2 * NW : 0), v);
  }
  __device__ __forceinline__ void X(const E& v) const { put(0, v); }
  __device__ __forceinline__ void Y(const E& v) const { put(1, v); }
  __device__ __forceinline__ void Z(const E& v) const { put(2, v); }
};

// dbl-2009-l, point.cuh's dbl (identity-safe: Z3 = 2*Y*Z = 0): 5 squares,
// then E (D - X3) beside Y Z.
template <int NW>
__device__ __forceinline__ void dbl2(const Pair2<NW>& f, const MemPoint2<NW>& P, const MemOut2<NW>& out) {
  using E = Fe<NW>;
  const E X = P.X();
  const E A = f.sqr(X);
  const E B = f.sqr(P.Y());
  const E XB2 = f.sqr(f.add(X, B));
  const E C = f.sqr(B);
  const E D = f.dbl(f.sub(f.sub(XB2, A), C));
  const E Ee = f.add(f.dbl(A), A);
  const E X3 = f.canon(f.sub(f.sqr(Ee), f.dbl(D)));
  const E eightC = f.dbl(f.dbl(f.dbl(C)));
  E EDX, YZ;
  f.mul2(EDX, YZ, Ee, f.sub(D, X3), P.Y(), P.Z());
  out.Y(f.canon(f.sub(EDX, eightC)));
  out.X(X3);
  out.Z(f.canon(f.dbl(YZ)));
}

// add-2007-bl, point.cuh's add_core (Z3 = 2 (Z1 Z2) H) with its select
// tree, its 12 products in 6 pairs.  Returns false where P == Q.
template <int NW>
__device__ __forceinline__ bool add2(const Pair2<NW>& f, const MemPoint2<NW>& P, const MemPoint2<NW>& Q,
                                     const MemOut2<NW>& out) {
  using E = Fe<NW>;
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
  const E Z2Z2 = f.sqr(Z2);
  E Z2c, U1;
  f.mul2(Z2c, U1, Z2, Z2Z2, P.X(), Z2Z2);
  const E Z1Z1 = f.sqr(Z1);
  E Z1Z2, Z1c;
  f.mul2(Z1Z2, Z1c, Z1, Z2, Z1, Z1Z1);
  E S1, U2;
  f.mul2(S1, U2, P.Y(), Z2c, Q.X(), Z1Z1);
  const E H = f.canon(f.sub(U2, U1));
  E S2, Z3;
  f.mul2(S2, Z3, Q.Y(), Z1c, f.dbl(Z1Z2), H);
  const E rr = f.canon(f.dbl(f.sub(S2, S1)));
  if (f.is_zero(H) && f.is_zero(rr)) return false;
  out.Z(f.canon(Z3));
  const E I = f.sqr(f.dbl(H));
  E J, V;
  f.mul2(J, V, H, I, U1, I);
  const E X3 = f.canon(f.sub(f.sub(f.sqr(rr), J), f.dbl(V)));
  E rVX, S1J;
  f.mul2(rVX, S1J, rr, f.sub(V, X3), S1, J);
  out.Y(f.canon(f.sub(rVX, f.dbl(S1J))));
  out.X(X3);
  return true;
}

// madd-2007-bl, point.cuh's add_mixed_core (Z3 = 2 Z1 H) with its select
// tree, its 8 products in 4 pairs; A = (x2, y2) affine, (0, 0) = identity.
// Returns false where P == Q.
template <int NW>
__device__ __forceinline__ bool add_mixed2(const Pair2<NW>& f, const MemPoint2<NW>& P, const MemPoint2<NW>& A,
                                           const MemOut2<NW>& out) {
  using E = Fe<NW>;
  const E Z1 = P.Z();
  const bool i2 = f.is_zero(A.X()) && f.is_zero(A.Y());
  if (f.is_zero(Z1)) {
    out.X(A.X()); out.Y(A.Y());
    out.Z(i2 ? f.zero() : f.one());
    return true;
  }
  if (i2) {
    out.X(P.X()); out.Y(P.Y()); out.Z(Z1);
    return true;
  }
  const E Z1Z1 = f.sqr(Z1);
  E U2, Z1c;
  f.mul2(U2, Z1c, A.X(), Z1Z1, Z1, Z1Z1);
  const E H = f.canon(f.sub(U2, P.X()));
  E S2, Z1H;
  f.mul2(S2, Z1H, A.Y(), Z1c, Z1, H);
  const E rr = f.canon(f.dbl(f.sub(S2, P.Y())));
  if (f.is_zero(H) && f.is_zero(rr)) return false;
  out.Z(f.canon(f.dbl(Z1H)));
  const E I = f.dbl(f.dbl(f.sqr(H)));
  E J, V;
  f.mul2(J, V, H, I, P.X(), I);
  const E X3 = f.canon(f.sub(f.sub(f.sqr(rr), J), f.dbl(V)));
  E rVX, Y1J;
  f.mul2(rVX, Y1J, rr, f.sub(V, X3), P.Y(), J);
  out.Y(f.canon(f.sub(rVX, f.dbl(Y1J))));
  out.X(X3);
  return true;
}

// The P == Q rows of the adds: rare, so kept out of the adds' code and
// register allocation.  Row i of coordinates 0.. is read again, the result
// goes to row i of the outputs.
template <int NW>
__device__ __noinline__ void double2_to(const PointArgs* a, long long i, const FieldConsts* fc) {
  const Pair2<NW> f(*fc);
  dbl2<NW>(f, MemPoint2<NW>{*a, f, 0, i}, MemOut2<NW>{*a, f, i});
}

// Row i = t / 2 on lanes t = 2i (c0) and 2i + 1 (c1); a block's 128 lanes
// hold 64 rows, so both lanes of a row share a block and a warp.
template <int NW, int OP>
__global__ void __launch_bounds__(kThreads, kPairBlocks)
    point2_kernel(const __grid_constant__ PointArgs args, const __grid_constant__ FieldConsts fc) {
  const long long i = ((long long)blockIdx.x * blockDim.x + threadIdx.x) >> 1;
  if (i >= args.n) return;  // both lanes of the row
  const Pair2<NW> f(fc);
  const MemOut2<NW> out{args, f, i};
  const MemPoint2<NW> P{args, f, 0, i};
  bool done = true;
  if (OP == kDouble) {
    dbl2<NW>(f, P, out);
  } else if (args.keep && args.keep[i]) {
    out.X(P.X()); out.Y(P.Y()); out.Z(P.Z());
  } else if (OP == kAdd) {
    done = add2<NW>(f, P, MemPoint2<NW>{args, f, 3, i}, out);
  } else {
    done = add_mixed2<NW>(f, P, MemPoint2<NW>{args, f, 3, i}, out);
  }
  if (!done) double2_to<NW>(&args, i, &fc);
}

template <int NW>
int launch2(int op, const PointArgs& a, const FieldConsts& fc, cudaStream_t s) {
  const unsigned blocks = (unsigned)((2 * a.n + kThreads - 1) / kThreads);
  switch (op) {
    case kAdd: point2_kernel<NW, kAdd><<<blocks, kThreads, 0, s>>>(a, fc); break;
    case kAddMixed: point2_kernel<NW, kAddMixed><<<blocks, kThreads, 0, s>>>(a, fc); break;
    case kDouble: point2_kernel<NW, kDouble><<<blocks, kThreads, 0, s>>>(a, fc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// The arguments are point_args.cuh's, coordinates of 4 * nw half-limbs.
extern "C" int tec_point_fp2(int op, int nw, const void* const* in, const long long* in_stride,
                             const void* keep, void* const* out, long long out_stride, long long n,
                             const uint32_t* fc, void* stream) {
  if (n <= 0) return 0;
  const PointArgs a = make_args(op, in, in_stride, keep, out, out_stride, n);
  const FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return launch2<8>(op, a, c, s);
  if (nw == 12) return launch2<12>(op, a, c, s);
  return (int)cudaErrorInvalidValue;
}
