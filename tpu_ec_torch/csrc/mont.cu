// K1: batched Montgomery product a*b*R^-1 mod p.
//
// Replaces tpu_ec/ops/pallas/mont.py:_mont_mul_call and _mont_mul_call_list
// (entry mont_mul_planes): the same values, canonical (< p), R = 2^(16L).
//
// Bound on the H100: integer-ALU.  A 381-bit product is 2*12*12 = 288
// 32x32->64 multiply-adds plus carries per element, against 3*48 = 144 bytes
// of traffic, far above the card's ops-per-byte balance.
//
// Simple design: one thread per element, the element's words in registers,
// field.cuh's even/odd carry-chain CIOS, then one conditional subtract.
// Each thread reads its 2*NW int32 half-limbs with 128-bit loads where the
// row is 16-byte aligned; warp-cooperative products and coalesced staging
// are later work.  The operand b has b_n rows that repeat along a: row
// i % b_n (b_n = 1, one constant; b_n = n, one row each; else the
// trailing axes of a, as the digit NTT's twiddle doubling multiplies every
// row of a table by one row of powers).
#include "field.cuh"

namespace {

template <int NW>
__global__ void mont_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                                int32_t* __restrict__ out, long long n, long long b_n,
                                tec::FieldConsts fc) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  const long long j = b_n == n ? i : (b_n == 1 ? 0 : i % b_n);
  tec::Fe<NW> x = tec::load_fe<NW>(a + i * 2 * NW);
  tec::Fe<NW> y = tec::load_fe<NW>(b + j * 2 * NW);
  tec::store_fe<NW>(out + i * 2 * NW, tec::fe_mul<NW>(x, y, fc));
}

}  // namespace

// a, out: (n, 2*nw) int32 half-limbs; b: (b_n, 2*nw), row i % b_n
// multiplying row i of a (b_n divides n).  fc: host array [np, p[12],
// one[12]].  Returns the CUDA error of the launch (0 on success).
extern "C" int tec_mont_mul(int nw, const void* a, const void* b, void* out, long long n,
                            long long b_n, const uint32_t* fc, void* stream) {
  if (n <= 0) return 0;
  if (b_n < 1 || n % b_n) return (int)cudaErrorInvalidValue;
  const int threads = 256;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  tec::FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) {
    mont_mul_kernel<8><<<blocks, threads, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                                  (int32_t*)out, n, b_n, c);
  } else if (nw == 12) {
    mont_mul_kernel<12><<<blocks, threads, 0, s>>>((const int32_t*)a, (const int32_t*)b,
                                                   (int32_t*)out, n, b_n, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

extern "C" const char* tec_error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}
