// K2: the digit-NTT inter-level twiddle, one fused pass per column.
//
// Replaces tpu_ec/ops/ntt_digit.py:_inter_call (entry inter_twiddle), both
// of its inputs: raw int32 GEMM columns, or (in_i8) 37 int8 base-2^7 digits
// -> base-2^7 carry -> the value v < 2^288 -> wide Montgomery product
// u = (v*T' + M*p) / 2^288 by the 2^288-scaled twiddle T' -> either 37 int8
// base-2^7 digits of u (the next level's GEMM input) or, when `canonical`,
// u mod p as 16 half-limbs (u < 2p, one subtract).
//
// Bound on the H100: memory.  With int32 columns a column moves about 250
// bytes (148 of columns in, 64 of twiddle, 37 of digits out); on the int8
// entry of the final pass 37 in and 64 out (the twiddle is one constant).
// Against that, 9*8 + 9*8 = 144 multiply-adds of the CIOS product plus the
// 42-step carry.
//
// Simple design: one thread per column.  Column reads are coalesced (the
// layout is digit-major, column-minor, as the GEMM leaves it); the int8
// entry is the same kernel instantiated on int8_t, so the digits are read
// as they are, with no int32 copy made first.  The value is carried
// serially into 7-bit digits and placed straight into 9 words (288 = 9*32);
// the product is field.cuh's CIOS with NA = 9 words of v and NB = 8 words
// of T' and p, so the radix is 2^288 and the word n' is the field's own
// -p^-1 mod 2^32.
//
// The twiddle of column i is row i / t_rep of an (nt, 16) table, the rows
// K1 writes (t_rep = the batch M of a four-step level, so no broadcast copy
// is made), or one constant row (t_const).  The canonical output is
// (16, n) planes or, with out_rows, (n, 16) rows.
// Fusing this epilogue into an int8 tensor-core GEMM is later work.
#include "field.cuh"

namespace {

constexpr int kDigitBits = 7;
constexpr int kWideWords = 9;   // R' = 2^288
constexpr int kCarryDigits = 42; // covers any value < 2^288
constexpr int kOutDigits = 37;   // ceil(256 / 7)

template <typename In>
__global__ void inter_kernel(const In* __restrict__ cols, int dc, const int32_t* __restrict__ t16,
                             int t_const, long long t_rep, void* __restrict__ out, int canonical,
                             int out_rows, long long n, tec::FieldConsts fc) {
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

  // twiddle: the 16 half-limbs of row i / t_rep
  const long long row = t_const ? 0 : (t_rep == 1 ? i : i / t_rep);
  const tec::Fe<8> f = tec::load_fe<8>(t16 + row * 16);
  uint32_t t[8];
#pragma unroll
  for (int k = 0; k < 8; ++k) t[k] = f.w[k];

  uint32_t u[10];
  tec::cios<kWideWords, 8>(u, v, t, fc.p, fc.np);

  if (canonical) {
    tec::Fe<8> r;
#pragma unroll
    for (int k = 0; k < 8; ++k) r.w[k] = u[k];
    r = tec::cond_sub_p<8>(r, u[8], fc);
    int32_t* o = (int32_t*)out;
    if (out_rows) {
      tec::store_fe<8>(o + i * 16, r);
    } else {
#pragma unroll
      for (int k = 0; k < 8; ++k) {
        o[(long long)(2 * k) * n + i] = (int32_t)(r.w[k] & 0xFFFFu);
        o[(long long)(2 * k + 1) * n + i] = (int32_t)(r.w[k] >> 16);
      }
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

// cols: (dc, n) int32, each in [0, 2^31), or with in_i8 (dc, n) int8
// digits in [0, 128).  t16: (n / t_rep, 16) int32 twiddle rows, or one
// (16,) row when t_const.  out: (37, n) int8, or (16, n) int32 when
// canonical ((n, 16) with out_rows).  fc: host constants of the 256-bit
// field.  Returns the launch's CUDA error.
extern "C" int tec_inter(const void* cols, int dc, int in_i8, const void* t16, int t_const,
                         long long t_rep, void* out, int canonical, int out_rows, long long n,
                         const uint32_t* fc, void* stream) {
  if (n <= 0) return 0;
  if (dc > kCarryDigits || t_rep < 1) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((n + threads - 1) / threads);
  const tec::FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (in_i8) {
    inter_kernel<int8_t><<<blocks, threads, 0, s>>>((const int8_t*)cols, dc, (const int32_t*)t16, t_const,
                                                    t_rep, out, canonical, out_rows, n, c);
  } else {
    inter_kernel<int32_t><<<blocks, threads, 0, s>>>((const int32_t*)cols, dc, (const int32_t*)t16, t_const,
                                                     t_rep, out, canonical, out_rows, n, c);
  }
  return (int)cudaGetLastError();
}
