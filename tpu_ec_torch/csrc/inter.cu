// K2: the digit-NTT inter-level twiddle, one fused pass per column.
//
// Replaces tpu_ec/ops/ntt_digit.py:_inter_call (entry inter_twiddle): raw
// int32 GEMM columns -> base-2^7 carry -> the value v < 2^288 -> wide
// Montgomery product u = (v*T' + M*p) / 2^288 by the 2^288-scaled twiddle
// T' -> either 37 int8 base-2^7 digits of u (the next level's GEMM input) or,
// when `canonical`, u mod p as 16 half-limbs (u < 2p, one subtract).
//
// Bound on the H100: integer-ALU, with about 250 bytes of traffic per
// column (148 of int32 columns in, 64 of twiddle, 37 of digits out) against
// 9*8 + 9*8 = 144 multiply-adds of the CIOS product plus the 42-step carry.
//
// Simple design: one thread per column.  Column reads are coalesced (the
// layout is digit-major, column-minor, as the GEMM leaves it); the value is
// carried serially into 7-bit digits and placed straight into 9 words
// (288 = 9*32); the product is field.cuh's CIOS with NA = 9 words of v and
// NB = 8 words of T' and p, so the radix is 2^288 and the word n' is the
// field's own -p^-1 mod 2^32.  Fusing this epilogue into an int8
// tensor-core GEMM is later work.
#include "field.cuh"

namespace {

constexpr int kDigitBits = 7;
constexpr int kWideWords = 9;   // R' = 2^288
constexpr int kCarryDigits = 42; // covers any value < 2^288
constexpr int kOutDigits = 37;   // ceil(256 / 7)

__global__ void inter_kernel(const int32_t* __restrict__ cols, int dc,
                             const int32_t* __restrict__ t16, int t_const, void* __restrict__ out,
                             int canonical, long long n, tec::FieldConsts fc) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;

  // base-2^7 carry of the columns, digits packed into v mod 2^288
  uint32_t v[kWideWords];
#pragma unroll
  for (int k = 0; k < kWideWords; ++k) v[k] = 0;
  uint64_t carry = 0;
#pragma unroll
  for (int e = 0; e < kCarryDigits; ++e) {
    uint64_t x = carry;
    if (e < dc) x += (uint32_t)cols[(long long)e * n + i];
    uint32_t d = (uint32_t)(x & 127u);
    carry = x >> kDigitBits;
    const int bit = e * kDigitBits, w = bit >> 5, off = bit & 31;
    if (w < kWideWords) v[w] |= d << off;
    if (off > 32 - kDigitBits && w + 1 < kWideWords) v[w + 1] |= d >> (32 - off);
  }

  // twiddle: 16 half-limbs, per column or one for all
  const int32_t* tp = t_const ? t16 : t16 + i;
  const long long ts = t_const ? 1 : n;
  uint32_t t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k)
    t[k] = (uint32_t)tp[(2 * k) * ts] | ((uint32_t)tp[(2 * k + 1) * ts] << 16);

  uint32_t u[10];
  tec::cios<kWideWords, 8>(u, v, t, fc.p, fc.np);

  if (canonical) {
    tec::Fe<8> r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = u[k];
    r = tec::cond_sub_p<8>(r, u[8], fc);
    int32_t* o = (int32_t*)out;
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      o[(long long)(2 * k) * n + i] = (int32_t)(r.w[k] & 0xFFFFu);
      o[(long long)(2 * k + 1) * n + i] = (int32_t)(r.w[k] >> 16);
    }
  } else {
    int8_t* o = (int8_t*)out;
#pragma unroll
    for (int e = 0; e < kOutDigits; ++e) {
      const int bit = e * kDigitBits, w = bit >> 5, off = bit & 31;
      uint32_t d = u[w] >> off;
      if (off > 32 - kDigitBits && w + 1 < 8) d |= u[w + 1] << (32 - off);
      o[(long long)e * n + i] = (int8_t)(d & 127u);
    }
  }
}

}  // namespace

// cols: (dc, n) int32, each in [0, 2^31).  t16: (16, n) int32 half-limbs, or
// (16,) when t_const.  out: (37, n) int8, or (16, n) int32 when canonical.
// fc: host constants of the 256-bit field.  Returns the launch's CUDA error.
extern "C" int tec_inter(const void* cols, int dc, const void* t16, int t_const, void* out,
                         int canonical, long long n, const uint32_t* fc, void* stream) {
  if (n <= 0) return 0;
  if (dc > kCarryDigits) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  inter_kernel<<<blocks, threads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)cols, dc, (const int32_t*)t16, t_const, out, canonical, n,
      tec::field_consts_from_host(fc));
  return (int)cudaGetLastError();
}
