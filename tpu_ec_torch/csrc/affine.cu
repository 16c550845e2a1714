// K6: the co-Z scaled-affine pair add, and K7: the batch-affine pair add
// (its denominator half and its apply half).
//
// K6 replaces tpu_ec/ops/pallas/affine.py:_coz_apply_call; K7 replaces
// :_denom_call and :_apply_call.  Each reproduces the case flags of
// affine.py:_flags (identity operands, P == Q, P == -Q and the order-2
// tangent) and the select order of its kernel, and every field op is
// canonical, so the outputs are bit-identical to tpu_ec's, not merely the
// same points.
//
// Bound on the H100: K6 is integer-ALU (9 Montgomery products per pair
// against 7 coordinates of traffic); the denominator half has no product
// and is bound by its 5 coordinates of traffic; the apply half does 3
// products a pair (4 on the rare tangent rows) against 7 coordinates, so
// at 12 words its IMAD time is ~3/4 of its bytes time: bytes-bound, with
// the products in the way where they do not overlap the traffic.
//
// K6 and the denominator half: one thread per pair, every temporary in
// registers, field.cuh's add, sub and CIOS product.  Coordinates are read
// with a row stride, as K3 reads them, so column slices of a fused (s, 2L)
// row matrix need no copy.  K6 reads its scale constants r2 = r^2 and r3 =
// r^3 per window: row i belongs to window i / rows_per_window, and each
// window has its own product-tree root r.
//
// The apply half (apply_kernel): one thread per pair too, but a warp moves
// the rows of its 32 pairs: where a coordinate's rows are 16-byte aligned,
// it reads them in consecutive 16-byte pieces (each load instruction 512
// contiguous bytes, not 32 rows' strided pieces) into a 3 KB staging
// buffer of its own in shared memory, from which each lane takes its row,
// and writes its outputs back the same way.  The tangent's 3 x1^2 is formed
// on the tangent rows only (a branch that is rare), so a warp of chords
// runs 3 products a pair, not 4.
#include "field.cuh"

namespace {

using tec::Fe;
using tec::FieldConsts;

constexpr int kDenom = 0, kApply = 1, kCoz = 2;
constexpr int kApplyThreads = 128;  // 4 warps, each moving the rows of its 32 pairs

struct AffineArgs {
  const int32_t* in[5];
  long long in_stride[5];
  int32_t* out[2];
  long long out_stride;
  long long n;
  const int32_t* r2;  // (windows, L) rows, K6 only
  const int32_t* r3;
  long long rows_per_window;
};

template <int NW>
__device__ __forceinline__ bool fe_eq(const Fe<NW>& a, const Fe<NW>& b) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i] ^ b.w[i];
  return acc == 0;
}

struct Flags {
  bool iz1, iz2, same, cancel;
};

// affine.py:_flags: same = both finite, equal, y != 0 (tangent); cancel =
// both finite, x equal and y different, or the order-2 tangent y1 == 0.
template <int NW>
__device__ __forceinline__ Flags flags(const Fe<NW>& x1, const Fe<NW>& y1, const Fe<NW>& x2,
                                       const Fe<NW>& y2) {
  using namespace tec;
  Flags f;
  f.iz1 = fe_is_zero<NW>(x1) && fe_is_zero<NW>(y1);
  f.iz2 = fe_is_zero<NW>(x2) && fe_is_zero<NW>(y2);
  const bool xeq = fe_eq<NW>(x1, x2), yeq = fe_eq<NW>(y1, y2), y1z = fe_is_zero<NW>(y1);
  const bool finite = !f.iz1 && !f.iz2;
  f.same = finite && xeq && yeq && !y1z;
  f.cancel = finite && xeq && (!yeq || y1z);
  return f;
}

// 3 * x1^2 (the tangent numerator, a = 0) or y2 - y1 (the chord).
template <int NW>
__device__ __forceinline__ Fe<NW> numerator(const Fe<NW>& x1, const Fe<NW>& y1, const Fe<NW>& y2,
                                            bool same, const FieldConsts& fc) {
  using namespace tec;
  Fe<NW> x1sq = fe_sqr<NW>(x1, fc);
  Fe<NW> three = fe_add<NW>(fe_add<NW>(x1sq, x1sq, fc), x1sq, fc);
  Fe<NW> chord = fe_sub<NW>(y2, y1, fc);
  return same ? three : chord;
}

// K7's denominator half (OP = kDenom) and K6 (OP = kCoz).
template <int NW, int OP>
__global__ void affine_kernel(AffineArgs args, FieldConsts fc) {
  using namespace tec;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= args.n) return;
  Fe<NW> x1 = load_fe<NW>(args.in[0] + i * args.in_stride[0]);
  Fe<NW> y1 = load_fe<NW>(args.in[1] + i * args.in_stride[1]);
  Fe<NW> x2 = load_fe<NW>(args.in[2] + i * args.in_stride[2]);
  Fe<NW> y2 = load_fe<NW>(args.in[3] + i * args.in_stride[3]);
  const Flags f = flags<NW>(x1, y1, x2, y2);
  if (OP == kDenom) {
    // chord x2 - x1 (nonzero whenever used), tangent 2*y1; degenerate -> 1
    Fe<NW> d = f.same ? fe_dbl<NW>(y1, fc) : fe_sub<NW>(x2, x1, fc);
    if (f.iz1 || f.iz2 || f.cancel) d = fe_const<NW>(fc.one);
    store_fe<NW>(args.out[0] + i * args.out_stride, d);
    return;
  }
  Fe<NW> e = load_fe<NW>(args.in[4] + i * args.in_stride[4]);  // pp
  Fe<NW> num = numerator<NW>(x1, y1, y2, f.same, fc);
  const long long win = i / args.rows_per_window;
  Fe<NW> r2 = load_fe<NW>(args.r2 + win * 2 * NW);
  Fe<NW> r3 = load_fe<NW>(args.r3 + win * 2 * NW);
  Fe<NW> t = fe_mul<NW>(num, e, fc);  // num * (R / d): the scaled slope
  Fe<NW> x1r2 = fe_mul<NW>(x1, r2, fc);
  Fe<NW> x2r2 = fe_mul<NW>(x2, r2, fc);
  Fe<NW> y1r3 = fe_mul<NW>(y1, r3, fc);
  Fe<NW> y2r3 = fe_mul<NW>(y2, r3, fc);
  Fe<NW> x3 = fe_sub<NW>(fe_sub<NW>(fe_sqr<NW>(t, fc), x1r2, fc), x2r2, fc);
  Fe<NW> y3 = fe_sub<NW>(fe_mul<NW>(t, fe_sub<NW>(x1r2, x3, fc), fc), y1r3, fc);
  // select order of _coz_apply_call: cancel, iz2, iz1, then both -> (0, 0)
  Fe<NW> ox = f.iz1 ? x2r2 : (f.iz2 ? x1r2 : (f.cancel ? fe_zero<NW>() : x3));
  Fe<NW> oy = f.iz1 ? y2r3 : (f.iz2 ? y1r3 : (f.cancel ? fe_zero<NW>() : y3));
  if (f.iz1 && f.iz2) {
    ox = fe_zero<NW>();
    oy = fe_zero<NW>();
  }
  store_fe<NW>(args.out[0] + i * args.out_stride, ox);
  store_fe<NW>(args.out[1] + i * args.out_stride, oy);
}

// The warp's rows row0 .. row0 + rows - 1 of one coordinate (base, row
// stride in int32), lane k receiving row row0 + k.  Where every row is
// 16-byte aligned the warp reads them in consecutive 16-byte pieces through
// buf (32 rows of 2 NW half-limbs); else each lane reads its own row.
template <int NW>
__device__ __forceinline__ Fe<NW> warp_load(const int32_t* base, long long stride, long long row0, int rows,
                                            int4* buf, int lane) {
  constexpr int P = NW / 2;  // 16-byte pieces a row
  if (((reinterpret_cast<uintptr_t>(base) | (uintptr_t)stride * 4) & 15) == 0) {
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int q = lane + 32 * m, r = q / P;
      if (r < rows) buf[q] = *reinterpret_cast<const int4*>(base + (row0 + r) * stride + 4 * (q - r * P));
    }
    __syncwarp();
    Fe<NW> e;
#pragma unroll
    for (int k = 0; k < P; ++k) {
      const int4 v = buf[lane * P + k];
      e.w[2 * k] = __byte_perm((uint32_t)v.x, (uint32_t)v.y, 0x5410);
      e.w[2 * k + 1] = __byte_perm((uint32_t)v.z, (uint32_t)v.w, 0x5410);
    }
    __syncwarp();
    return e;
  }
  return lane < rows ? tec::load_fe<NW>(base + (row0 + lane) * stride) : tec::fe_zero<NW>();
}

// warp_load's inverse: lane k's e goes to row row0 + k (k < rows).
template <int NW>
__device__ __forceinline__ void warp_store(int32_t* base, long long stride, long long row0, int rows,
                                           const Fe<NW>& e, int4* buf, int lane) {
  constexpr int P = NW / 2;
  if (((reinterpret_cast<uintptr_t>(base) | (uintptr_t)stride * 4) & 15) == 0) {
#pragma unroll
    for (int k = 0; k < P; ++k)
      buf[lane * P + k] = make_int4((int32_t)(e.w[2 * k] & 0xFFFFu), (int32_t)(e.w[2 * k] >> 16),
                                    (int32_t)(e.w[2 * k + 1] & 0xFFFFu), (int32_t)(e.w[2 * k + 1] >> 16));
    __syncwarp();
#pragma unroll
    for (int m = 0; m < P; ++m) {
      const int q = lane + 32 * m, r = q / P;
      if (r < rows) *reinterpret_cast<int4*>(base + (row0 + r) * stride + 4 * (q - r * P)) = buf[q];
    }
    __syncwarp();
  } else if (lane < rows) {
    tec::store_fe<NW>(base + (row0 + lane) * stride, e);
  }
}

// K7's apply half: (x3, y3) of pair i from its inverted denominator iv,
// lane k of a warp taking pair row0 + k.
template <int NW>
__global__ void __launch_bounds__(kApplyThreads)
    apply_kernel(const __grid_constant__ AffineArgs args, const __grid_constant__ FieldConsts fc) {
  using namespace tec;
  __shared__ int4 stage[kApplyThreads / 32][32 * NW / 2];
  const int lane = threadIdx.x & 31;
  const long long row0 = (long long)blockIdx.x * kApplyThreads + (threadIdx.x & ~31);
  if (row0 >= args.n) return;  // the whole warp
  const int rows = args.n - row0 < 32 ? (int)(args.n - row0) : 32;
  int4* buf = stage[threadIdx.x >> 5];
  const auto in = [&](int k) { return warp_load<NW>(args.in[k], args.in_stride[k], row0, rows, buf, lane); };
  const Fe<NW> x1 = in(0), y1 = in(1), x2 = in(2), y2 = in(3);
  const Flags f = flags<NW>(x1, y1, x2, y2);
  const Fe<NW> iv = in(4);
  Fe<NW> num = fe_sub<NW>(y2, y1, fc);  // the chord's numerator
  if (f.same) {  // the tangent's 3 x1^2
    const Fe<NW> x1sq = fe_sqr<NW>(x1, fc);
    num = fe_add<NW>(fe_add<NW>(x1sq, x1sq, fc), x1sq, fc);
  }
  const Fe<NW> lam = fe_mul<NW>(num, iv, fc);
  const Fe<NW> x3 = fe_sub<NW>(fe_sub<NW>(fe_sqr<NW>(lam, fc), x1, fc), x2, fc);
  const Fe<NW> y3 = fe_sub<NW>(fe_mul<NW>(lam, fe_sub<NW>(x1, x3, fc), fc), y1, fc);
  // select order of _apply_call: cancel, then iz2, then iz1
  const Fe<NW> ox = f.iz1 ? x2 : (f.iz2 ? x1 : (f.cancel ? fe_zero<NW>() : x3));
  const Fe<NW> oy = f.iz1 ? y2 : (f.iz2 ? y1 : (f.cancel ? fe_zero<NW>() : y3));
  warp_store<NW>(args.out[0], args.out_stride, row0, rows, ox, buf, lane);
  warp_store<NW>(args.out[1], args.out_stride, row0, rows, oy, buf, lane);
}

template <int NW>
int launch(int op, const AffineArgs& a, const FieldConsts& fc, cudaStream_t s) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((a.n + threads - 1) / threads);
  switch (op) {
    case kDenom: affine_kernel<NW, kDenom><<<blocks, threads, 0, s>>>(a, fc); break;
    case kApply:
      apply_kernel<NW><<<(unsigned)((a.n + kApplyThreads - 1) / kApplyThreads), kApplyThreads, 0, s>>>(a, fc);
      break;
    case kCoz: affine_kernel<NW, kCoz><<<blocks, threads, 0, s>>>(a, fc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 denom (x1, y1, x2, y2 -> d), 1 apply (x1, y1, x2, y2, iv -> x3, y3),
// 2 co-Z apply (x1, y1, x2, y2, pp -> x3, y3, with r2/r3 (windows, 2*nw)
// rows and rows_per_window).  in/out: device pointers to (n, 2*nw) int32
// half-limb coordinates with the given row strides (in int32 elements).
// Returns the launch's CUDA error.
extern "C" int tec_affine(int op, int nw, const void* const* in, const long long* in_stride,
                          void* const* out, long long out_stride, long long n, const void* r2,
                          const void* r3, long long rows_per_window, const uint32_t* fc,
                          void* stream) {
  if (n <= 0) return 0;
  if (op == kCoz && rows_per_window <= 0) return (int)cudaErrorInvalidValue;
  AffineArgs a;
  const int n_in = op == kDenom ? 4 : 5;
  for (int k = 0; k < 5; ++k) {
    a.in[k] = k < n_in ? (const int32_t*)in[k] : nullptr;
    a.in_stride[k] = k < n_in ? in_stride[k] : 0;
  }
  a.out[0] = (int32_t*)out[0];
  a.out[1] = op == kDenom ? nullptr : (int32_t*)out[1];
  a.out_stride = out_stride;
  a.n = n;
  a.r2 = (const int32_t*)r2;
  a.r3 = (const int32_t*)r3;
  a.rows_per_window = rows_per_window;
  FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return launch<8>(op, a, c, s);
  if (nw == 12) return launch<12>(op, a, c, s);
  return (int)cudaErrorInvalidValue;
}
