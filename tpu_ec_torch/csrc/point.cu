// K3: batched Jacobian point ops over a short-Weierstrass a = 0 curve.
//
// Replaces tpu_ec/ops/pallas/point.py:_point_call_list (and _point_call;
// entries jac_add, jac_add_mixed, jac_double): add-2007-bl, madd-2007-bl and
// dbl-2009-l with the completeness select tree of
// tpu_ec/ops/pallas/point.py:_add_body/_add_mixed_body (identity, P == Q,
// P == -Q).  Every field op returns canonical values, so the Jacobian
// outputs are bit-identical to tpu_ec's PointOps, not merely the same point.
//
// Bound on the H100: integer-ALU.  An add is 16 field products of 288
// multiply-adds each for BLS12-381 (about 4,600 per point) against
// 9 * 48 = 432 bytes of traffic.
//
// Simple design: one thread per point, the coordinates and every temporary
// in registers (12 words per element, ~15 live elements: up to 250
// registers a thread, which limits occupancy), field.cuh's CIOS for the
// products.  Where the TPU computed every branch
// and selected, each thread branches on its own case, which gives the same
// values: identity inputs return at once, and the doubling runs only on
// P == Q rows.  Coordinates are read with a row stride so that callers can
// pass column slices of one fused (n, 3L) row matrix without a copy.
#include "field.cuh"

namespace {

using tec::Fe;
using tec::FieldConsts;

constexpr int kAdd = 0, kAddMixed = 1, kDouble = 2;

struct PointArgs {
  const int32_t* in[6];
  long long in_stride[6];
  int32_t* out[3];
  long long out_stride;
  long long n;
};

// dbl-2009-l (ec.cl:17-42); identity-safe: Z3 = 2*Y*Z = 0.
template <int NW>
__device__ __forceinline__ void dbl(const Fe<NW>& X, const Fe<NW>& Y, const Fe<NW>& Z,
                                    Fe<NW>& X3, Fe<NW>& Y3, Fe<NW>& Z3, const FieldConsts& fc) {
  using namespace tec;
  Fe<NW> A = fe_sqr<NW>(X, fc);
  Fe<NW> B = fe_sqr<NW>(Y, fc);
  Fe<NW> C = fe_sqr<NW>(B, fc);
  Fe<NW> D = fe_dbl<NW>(
      fe_sub<NW>(fe_sub<NW>(fe_sqr<NW>(fe_add<NW>(X, B, fc), fc), A, fc), C, fc), fc);
  Fe<NW> E = fe_add<NW>(fe_dbl<NW>(A, fc), A, fc);
  Fe<NW> FF = fe_sqr<NW>(E, fc);
  X3 = fe_sub<NW>(FF, fe_dbl<NW>(D, fc), fc);
  Fe<NW> eightC = fe_dbl<NW>(fe_dbl<NW>(fe_dbl<NW>(C, fc), fc), fc);
  Y3 = fe_sub<NW>(fe_mul<NW>(E, fe_sub<NW>(D, X3, fc), fc), eightC, fc);
  Z3 = fe_dbl<NW>(fe_mul<NW>(Y, Z, fc), fc);
}

template <int NW, int OP>
__global__ void point_kernel(PointArgs args, FieldConsts fc) {
  using namespace tec;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= args.n) return;
  Fe<NW> X1 = load_fe<NW>(args.in[0] + i * args.in_stride[0]);
  Fe<NW> Y1 = load_fe<NW>(args.in[1] + i * args.in_stride[1]);
  Fe<NW> Z1 = load_fe<NW>(args.in[2] + i * args.in_stride[2]);
  Fe<NW> X3, Y3, Z3;
  if (OP == kDouble) {
    dbl<NW>(X1, Y1, Z1, X3, Y3, Z3, fc);
  } else if (OP == kAdd) {
    Fe<NW> X2 = load_fe<NW>(args.in[3] + i * args.in_stride[3]);
    Fe<NW> Y2 = load_fe<NW>(args.in[4] + i * args.in_stride[4]);
    Fe<NW> Z2 = load_fe<NW>(args.in[5] + i * args.in_stride[5]);
    if (fe_is_zero<NW>(Z1)) {
      X3 = X2; Y3 = Y2; Z3 = Z2;
    } else if (fe_is_zero<NW>(Z2)) {
      X3 = X1; Y3 = Y1; Z3 = Z1;
    } else {
      // add-2007-bl (ec.cl:85-120)
      Fe<NW> Z1Z1 = fe_sqr<NW>(Z1, fc);
      Fe<NW> Z2Z2 = fe_sqr<NW>(Z2, fc);
      Fe<NW> U1 = fe_mul<NW>(X1, Z2Z2, fc);
      Fe<NW> U2 = fe_mul<NW>(X2, Z1Z1, fc);
      Fe<NW> S1 = fe_mul<NW>(Y1, fe_mul<NW>(Z2, Z2Z2, fc), fc);
      Fe<NW> S2 = fe_mul<NW>(Y2, fe_mul<NW>(Z1, Z1Z1, fc), fc);
      Fe<NW> H = fe_sub<NW>(U2, U1, fc);
      Fe<NW> rr = fe_dbl<NW>(fe_sub<NW>(S2, S1, fc), fc);
      if (fe_is_zero<NW>(H) && fe_is_zero<NW>(rr)) {
        dbl<NW>(X1, Y1, Z1, X3, Y3, Z3, fc);
      } else {
        Fe<NW> I = fe_sqr<NW>(fe_dbl<NW>(H, fc), fc);
        Fe<NW> J = fe_mul<NW>(H, I, fc);
        Fe<NW> V = fe_mul<NW>(U1, I, fc);
        X3 = fe_sub<NW>(fe_sub<NW>(fe_sqr<NW>(rr, fc), J, fc), fe_dbl<NW>(V, fc), fc);
        Y3 = fe_sub<NW>(fe_mul<NW>(rr, fe_sub<NW>(V, X3, fc), fc),
                        fe_dbl<NW>(fe_mul<NW>(S1, J, fc), fc), fc);
        Z3 = fe_mul<NW>(
            fe_sub<NW>(fe_sub<NW>(fe_sqr<NW>(fe_add<NW>(Z1, Z2, fc), fc), Z1Z1, fc), Z2Z2, fc),
            H, fc);
      }
    }
  } else {  // kAddMixed: (X2, Y2) affine, (0, 0) = identity
    Fe<NW> X2 = load_fe<NW>(args.in[3] + i * args.in_stride[3]);
    Fe<NW> Y2 = load_fe<NW>(args.in[4] + i * args.in_stride[4]);
    const bool i2 = fe_is_zero<NW>(X2) && fe_is_zero<NW>(Y2);
    if (fe_is_zero<NW>(Z1)) {
      X3 = X2; Y3 = Y2;
      Z3 = i2 ? fe_zero<NW>() : fe_const<NW>(fc.one);
    } else if (i2) {
      X3 = X1; Y3 = Y1; Z3 = Z1;
    } else {
      // madd-2007-bl (ec.cl:45-82)
      Fe<NW> Z1Z1 = fe_sqr<NW>(Z1, fc);
      Fe<NW> U2 = fe_mul<NW>(X2, Z1Z1, fc);
      Fe<NW> S2 = fe_mul<NW>(Y2, fe_mul<NW>(Z1, Z1Z1, fc), fc);
      Fe<NW> H = fe_sub<NW>(U2, X1, fc);
      Fe<NW> rr = fe_dbl<NW>(fe_sub<NW>(S2, Y1, fc), fc);
      if (fe_is_zero<NW>(H) && fe_is_zero<NW>(rr)) {
        dbl<NW>(X1, Y1, Z1, X3, Y3, Z3, fc);
      } else {
        Fe<NW> HH = fe_sqr<NW>(H, fc);
        Fe<NW> I = fe_dbl<NW>(fe_dbl<NW>(HH, fc), fc);
        Fe<NW> J = fe_mul<NW>(H, I, fc);
        Fe<NW> V = fe_mul<NW>(X1, I, fc);
        X3 = fe_sub<NW>(fe_sub<NW>(fe_sqr<NW>(rr, fc), J, fc), fe_dbl<NW>(V, fc), fc);
        Y3 = fe_sub<NW>(fe_mul<NW>(rr, fe_sub<NW>(V, X3, fc), fc),
                        fe_dbl<NW>(fe_mul<NW>(Y1, J, fc), fc), fc);
        Z3 = fe_sub<NW>(fe_sub<NW>(fe_sqr<NW>(fe_add<NW>(Z1, H, fc), fc), Z1Z1, fc), HH, fc);
      }
    }
  }
  store_fe<NW>(args.out[0] + i * args.out_stride, X3);
  store_fe<NW>(args.out[1] + i * args.out_stride, Y3);
  store_fe<NW>(args.out[2] + i * args.out_stride, Z3);
}

template <int NW>
int launch(int op, const PointArgs& a, const FieldConsts& fc, cudaStream_t s) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((a.n + threads - 1) / threads);
  switch (op) {
    case kAdd: point_kernel<NW, kAdd><<<blocks, threads, 0, s>>>(a, fc); break;
    case kAddMixed: point_kernel<NW, kAddMixed><<<blocks, threads, 0, s>>>(a, fc); break;
    case kDouble: point_kernel<NW, kDouble><<<blocks, threads, 0, s>>>(a, fc); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// op: 0 add (6 inputs), 1 add_mixed (5), 2 double (3).  in/out: arrays of
// device pointers to (n, 2*nw) int32 half-limb coordinates with the given
// row strides (in int32 elements).  Returns the launch's CUDA error.
extern "C" int tec_point(int op, int nw, const void* const* in, const long long* in_stride,
                         void* const* out, long long out_stride, long long n,
                         const uint32_t* fc, void* stream) {
  if (n <= 0) return 0;
  PointArgs a;
  const int n_in = op == kAdd ? 6 : (op == kAddMixed ? 5 : 3);
  for (int k = 0; k < 6; ++k) {
    a.in[k] = k < n_in ? (const int32_t*)in[k] : nullptr;
    a.in_stride[k] = k < n_in ? in_stride[k] : 0;
  }
  for (int k = 0; k < 3; ++k) a.out[k] = (int32_t*)out[k];
  a.out_stride = out_stride;
  a.n = n;
  FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return launch<8>(op, a, c, s);
  if (nw == 12) return launch<12>(op, a, c, s);
  return (int)cudaErrorInvalidValue;
}
