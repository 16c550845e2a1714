// K3: batched Jacobian point ops over a short-Weierstrass a = 0 curve.
//
// Replaces tpu_ec/ops/pallas/point.py:_point_call_list (and _point_call;
// entries jac_add, jac_add_mixed, jac_double): add-2007-bl, madd-2007-bl and
// dbl-2009-l with the completeness select tree of
// tpu_ec/ops/pallas/point.py:_add_body/_add_mixed_body (identity, P == Q,
// P == -Q).  (K3's chain entries, the Horner window combine, the scalar
// multiplication and the EC-FFT stage, are chain.cu, on the lane-tile field
// core.)  Every stored value is canonical, so the Jacobian outputs are
// bit-identical to tpu_ec's PointOps, not merely the same point.
//
// Bound on the H100: integer-ALU.  An add is 16 field products (11 for the
// mixed add) of about 600 IMADs each for BLS12-381 against 9 * 96 bytes of
// half-limb traffic.
//
// Design.  One thread per point.  Inside a formula values are reduced
// lazily, in [0, 2p) (field.cuh *_lazy), and made canonical before every
// zero test and every store.  The formulas are ordered so that few field
// elements are live at once, and the operands are read from memory at their
// first use (MemPoint), so a coordinate is not held in registers through
// the formula; the rare P == Q doubling of the adds runs in a separate
// non-inlined function that reads P again.  That keeps the point kernel
// within __launch_bounds__(128, 4): at most 128 registers, 16 warps an SM.
// Coordinates are read with row strides (column slices of one fused row
// matrix need no copy) by 128-bit loads where a row is 16-byte aligned.
// The adds take an optional per-row keep mask (copy P, lifted to Jacobian,
// instead of adding: where(~keep, P + Q, P)), and the mixed add an affine
// P (z omitted), so the pair MSM writes its fused rows directly.
//
// The G2 (Fq2) instances are g2_point.cu's, a kernel body of their own on
// two lanes a row; both take point_args.cuh's arguments.
#pragma once

#include "field.cuh"
#include "point_args.cuh"

namespace tec {

// The coordinate field the formulas below are written against: Fq, on
// field.cuh's one-thread functions.
template <int NW>
struct Ext1 {
  using E = Fe<NW>;
  static __device__ __forceinline__ E mul(const E& a, const E& b, const FieldConsts& fc) {
    return fe_mul_lazy<NW>(a, b, fc);
  }
  static __device__ __forceinline__ E sqr(const E& a, const FieldConsts& fc) { return fe_sqr_lazy<NW>(a, fc); }
  static __device__ __forceinline__ E add(const E& a, const E& b, const FieldConsts& fc) {
    return fe_add_lazy<NW>(a, b, fc);
  }
  static __device__ __forceinline__ E sub(const E& a, const E& b, const FieldConsts& fc) {
    return fe_sub_lazy<NW>(a, b, fc);
  }
  static __device__ __forceinline__ E dbl(const E& a, const FieldConsts& fc) { return fe_dbl_lazy<NW>(a, fc); }
  static __device__ __forceinline__ E canon(const E& a, const FieldConsts& fc) { return fe_canon<NW>(a, fc); }
  static __device__ __forceinline__ bool is_zero(const E& a) { return fe_is_zero<NW>(a); }
  static __device__ __forceinline__ E zero() { return fe_zero<NW>(); }
  static __device__ __forceinline__ E one(const FieldConsts& fc) { return fe_const<NW>(fc.one); }
  static __device__ __forceinline__ E load(const int32_t* src) { return load_fe<NW>(src); }
  static __device__ __forceinline__ void store(int32_t* dst, const E& a) { store_fe<NW>(dst, a); }
};

}  // namespace tec

namespace {

using tec::FieldConsts;

constexpr int kMinBlocks = 4;  // 4 blocks of 4 warps an SM: <= 128 registers

// A point operand read from device memory at each use: coordinates k,
// k + 1, k + 2 of the kernel's arguments at row i, each address formed
// where it is read (the arguments stay in the parameter space, so no row
// pointer holds registers).  A null z pointer: an affine point (x, y)
// lifted to Jacobian, z = 1 (R mod p) or 0 for (0, 0).
template <class F>
struct MemPoint {
  using E = typename F::E;
  const PointArgs& a;
  int k;
  long long i;
  __device__ __forceinline__ E at(int c) const { return F::load(a.in[k + c] + i * a.in_stride[k + c]); }
  __device__ __forceinline__ E X() const { return at(0); }
  __device__ __forceinline__ E Y() const { return at(1); }
  __device__ __forceinline__ E Z(const FieldConsts& fc) const {
    if (a.in[k + 2]) return at(2);
    return F::is_zero(X()) && F::is_zero(Y()) ? F::zero() : F::one(fc);
  }
};

// Where an op's result goes, one coordinate at a time as soon as it is
// final (canonical): device memory, so it leaves the registers at once.
template <class F>
struct MemOut {
  using E = typename F::E;
  const PointArgs& a;
  long long i;
  __device__ __forceinline__ void put(int c, const E& v) const { F::store(a.out[c] + i * a.out_stride, v); }
  __device__ __forceinline__ void X(const E& v) const { put(0, v); }
  __device__ __forceinline__ void Y(const E& v) const { put(1, v); }
  __device__ __forceinline__ void Z(const E& v) const { put(2, v); }
};

// dbl-2009-l (ec.cl:17-42); identity-safe: Z3 = 2*Y*Z = 0.
template <class F, class Out>
__device__ __forceinline__ void dbl(const typename F::E& X, const typename F::E& Y, const typename F::E& Z,
                                    const Out& out, const FieldConsts& fc) {
  using E = typename F::E;
  out.Z(F::canon(F::dbl(F::mul(Y, Z, fc), fc), fc));
  E A = F::sqr(X, fc);
  E B = F::sqr(Y, fc);
  E D = F::sub(F::sqr(F::add(X, B, fc), fc), A, fc);
  E C = F::sqr(B, fc);
  D = F::dbl(F::sub(D, C, fc), fc);
  E Ee = F::add(F::dbl(A, fc), A, fc);
  E X3 = F::canon(F::sub(F::sqr(Ee, fc), F::dbl(D, fc), fc), fc);
  E eightC = F::dbl(F::dbl(F::dbl(C, fc), fc), fc);
  out.Y(F::canon(F::sub(F::mul(Ee, F::sub(D, X3, fc), fc), eightC, fc), fc));
  out.X(X3);
}

// add-2007-bl (ec.cl:85-120) with the select tree of PointOps.add: P
// identity -> Q, else Q identity -> P, else P == Q -> returns false and
// leaves the doubling of P to the caller.
template <class F, class SP, class SQ, class Out>
__device__ __forceinline__ bool add_core(const SP& P, const SQ& Q, const Out& out, const FieldConsts& fc) {
  using E = typename F::E;
  const E Z1 = P.Z(fc);
  const E Z2 = Q.Z(fc);
  if (F::is_zero(Z1)) {
    out.X(Q.X()); out.Y(Q.Y()); out.Z(Z2);
    return true;
  }
  if (F::is_zero(Z2)) {
    out.X(P.X()); out.Y(P.Y()); out.Z(Z1);
    return true;
  }
  // Z3 = ((Z1 + Z2)^2 - Z1Z1 - Z2Z2) * H is formed as 2 * (Z1 * Z2) * H:
  // the same residue with the same number of products, and stored
  // canonical the same value.  Z1 * Z2 comes first, then the Z2 chain (U1,
  // S1), then Z1's, so that few elements are live at once.
  E Z1Z2 = F::mul(Z1, Z2, fc);
  E Z2Z2 = F::sqr(Z2, fc);
  E S1 = F::mul(Z2, Z2Z2, fc);
  E U1 = F::mul(P.X(), Z2Z2, fc);
  S1 = F::mul(P.Y(), S1, fc);
  E Z1Z1 = F::sqr(Z1, fc);
  E Z1c = F::mul(Z1, Z1Z1, fc);
  E H = F::canon(F::sub(F::mul(Q.X(), Z1Z1, fc), U1, fc), fc);
  E rr = F::canon(F::dbl(F::sub(F::mul(Q.Y(), Z1c, fc), S1, fc), fc), fc);
  if (F::is_zero(H) && F::is_zero(rr)) return false;
  out.Z(F::canon(F::mul(F::dbl(Z1Z2, fc), H, fc), fc));
  E I = F::sqr(F::dbl(H, fc), fc);
  E J = F::mul(H, I, fc);
  E V = F::mul(U1, I, fc);
  E X3 = F::canon(F::sub(F::sub(F::sqr(rr, fc), J, fc), F::dbl(V, fc), fc), fc);
  out.Y(F::canon(F::sub(F::mul(rr, F::sub(V, X3, fc), fc), F::dbl(F::mul(S1, J, fc), fc), fc), fc));
  out.X(X3);
  return true;
}

// madd-2007-bl (ec.cl:45-82) with the select tree of PointOps.add_mixed;
// A = (x2, y2) affine, (0, 0) = identity.  Returns false where P == Q.
template <class F, class SP, class SA, class Out>
__device__ __forceinline__ bool add_mixed_core(const SP& P, const SA& A, const Out& out, const FieldConsts& fc) {
  using E = typename F::E;
  const E Z1 = P.Z(fc);
  const bool i2 = F::is_zero(A.X()) && F::is_zero(A.Y());
  if (F::is_zero(Z1)) {
    out.X(A.X()); out.Y(A.Y());
    out.Z(i2 ? F::zero() : F::one(fc));
    return true;
  }
  if (i2) {
    out.X(P.X()); out.Y(P.Y()); out.Z(Z1);
    return true;
  }
  // Z3 = (Z1 + H)^2 - Z1Z1 - HH is formed as 2 * Z1 * H: the same
  // residue and product count, and Z1Z1 need not live until the end.
  E Z1Z1 = F::sqr(Z1, fc);
  E H = F::canon(F::sub(F::mul(A.X(), Z1Z1, fc), P.X(), fc), fc);
  E rr = F::canon(F::dbl(F::sub(F::mul(A.Y(), F::mul(Z1, Z1Z1, fc), fc), P.Y(), fc), fc), fc);
  if (F::is_zero(H) && F::is_zero(rr)) return false;
  out.Z(F::canon(F::dbl(F::mul(Z1, H, fc), fc), fc));
  E I = F::dbl(F::dbl(F::sqr(H, fc), fc), fc);
  E J = F::mul(H, I, fc);
  E V = F::mul(P.X(), I, fc);
  E X3 = F::canon(F::sub(F::sub(F::sqr(rr, fc), J, fc), F::dbl(V, fc), fc), fc);
  out.Y(F::canon(F::sub(F::mul(rr, F::sub(V, X3, fc), fc), F::dbl(F::mul(P.Y(), J, fc), fc), fc), fc));
  out.X(X3);
  return true;
}

// The P == Q rows of the adds: rare, so kept out of the adds' code and
// register allocation.  The operand, row i of coordinates k.., is read again
// from memory; the result goes to row o.
template <class F>
__device__ __noinline__ void double_to(const PointArgs* a, int k, long long i, long long o,
                                       const FieldConsts* fc) {
  const MemPoint<F> P{*a, k, i};
  dbl<F>(P.X(), P.Y(), P.Z(*fc), MemOut<F>{*a, o}, *fc);
}

template <class F, int OP>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    point_kernel(const __grid_constant__ PointArgs args, const __grid_constant__ FieldConsts fc) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= args.n) return;
  const MemOut<F> out{args, i};
  const MemPoint<F> P{args, 0, i};
  bool done = true;
  if (OP == kDouble) {
    dbl<F>(P.X(), P.Y(), P.Z(fc), out, fc);
  } else if (args.keep && args.keep[i]) {
    out.X(P.X()); out.Y(P.Y()); out.Z(P.Z(fc));
  } else if (OP == kAdd) {
    done = add_core<F>(P, MemPoint<F>{args, 3, i}, out, fc);
  } else {
    done = add_mixed_core<F>(P, MemPoint<F>{args, 3, i}, out, fc);
  }
  if (!done) double_to<F>(&args, 0, i, i, &fc);
}

template <class F>
int launch(int op, const PointArgs& a, const FieldConsts& fc, cudaStream_t s) {
  const unsigned blocks = (unsigned)((a.n + kThreads - 1) / kThreads);
  switch (op) {
    case kAdd: point_kernel<F, kAdd><<<blocks, kThreads, 0, s>>>(a, fc); break;
    case kAddMixed: point_kernel<F, kAddMixed><<<blocks, kThreads, 0, s>>>(a, fc); break;
    case kDouble: point_kernel<F, kDouble><<<blocks, kThreads, 0, s>>>(a, fc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace
