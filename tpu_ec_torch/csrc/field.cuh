// Montgomery field arithmetic on 32-bit words, one element per thread.
//
// Shared by every kernel (K1-K7).  An element lives in NW 32-bit words (8
// for 256-bit fields, 12 for BLS12-381 Fq), packed from the port's storage
// layout of 2*NW 16-bit half-limbs held in int32.  The Montgomery radix is
// R = 2^(32*NW) = 2^(16*L), the same R as the reference
// (tpu_ec/fields/params.py), so values cross over unchanged.
//
// Word arithmetic uses PTX carry chains (add.cc / addc, sub.cc / subc,
// mad.lo.cc / madc.hi.cc), so a carry lives in the carry flag instead of a
// 64-bit accumulator.  The field product is word-serial CIOS with
// n' = -p^-1 mod 2^32 (the reference CUDA/OpenCL field template,
// field.cl:268-299) in the even/odd form (mul_eo): the two halves of each
// 32x32 product sit on adjacent words of one chain, which ptxas turns into
// one IMAD.WIDE.U32.X, and the even and odd words of a run in two
// independent chains.  The square is the same product.  K2's 9 x 8-word
// product (an odd number of rows) keeps the single-accumulator CIOS
// (cios).  The canonical functions (fe_*)
// return the canonical value (< p) for canonical inputs, so any sequence of
// them is bit-identical to the same sequence of tpu_ec FieldOps calls.
//
// Lazy variants (*_lazy) map [0, 2p) to [0, 2p) and skip the products'
// final subtraction.  They need 4p < R, which holds for every field of the
// port (BLS12-381 Fq: p < 2^381, R = 2^384; BN254: p < 2^254, R = 2^256):
// a product of two values below 2p is (ab + Mp)/R < 4p^2/R + p < 2p.  A
// caller reduces with fe_canon before comparing or storing.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace tec {

constexpr int kMaxWords = 12;

// Per-field constants, passed by value as a kernel parameter.
struct FieldConsts {
  uint32_t np;               // -p^-1 mod 2^32
  uint32_t p[kMaxWords];     // modulus
  uint32_t one[kMaxWords];   // R mod p (Montgomery one)
  uint32_t p2[kMaxWords];    // 2p (lazy reduction)
};

// Host layout of the constants: [np, p[0..11], one[0..11]] (25 words).
inline FieldConsts field_consts_from_host(const uint32_t* h) {
  FieldConsts fc;
  fc.np = h[0];
  uint64_t c = 0;
  for (int i = 0; i < kMaxWords; ++i) {
    fc.p[i] = h[1 + i];
    fc.one[i] = h[1 + kMaxWords + i];
    c += 2 * (uint64_t)fc.p[i];
    fc.p2[i] = (uint32_t)c;
    c >>= 32;
  }
  return fc;
}

template <int NW>
struct Fe {
  uint32_t w[NW];
};

// ---- carry-chain primitives (the carry flag links consecutive calls) ----

__device__ __forceinline__ void add_cc(uint32_t& r, uint32_t a, uint32_t b) {
  asm volatile("add.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
}
__device__ __forceinline__ void addc_cc(uint32_t& r, uint32_t a, uint32_t b) {
  asm volatile("addc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
}
__device__ __forceinline__ void addc(uint32_t& r, uint32_t a, uint32_t b) {
  asm volatile("addc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
}
__device__ __forceinline__ void sub_cc(uint32_t& r, uint32_t a, uint32_t b) {
  asm volatile("sub.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
}
__device__ __forceinline__ void subc_cc(uint32_t& r, uint32_t a, uint32_t b) {
  asm volatile("subc.cc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
}
__device__ __forceinline__ void subc(uint32_t& r, uint32_t a, uint32_t b) {
  asm volatile("subc.u32 %0, %1, %2;" : "=r"(r) : "r"(a), "r"(b));
}
// acc += lo(a*b) / hi(a*b), with carry in (madc) and out (.cc)
__device__ __forceinline__ void mad_lo_cc(uint32_t& acc, uint32_t a, uint32_t b) {
  asm volatile("mad.lo.cc.u32 %0, %1, %2, %0;" : "+r"(acc) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_lo_cc(uint32_t& acc, uint32_t a, uint32_t b) {
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %0;" : "+r"(acc) : "r"(a), "r"(b));
}
__device__ __forceinline__ void mad_hi_cc(uint32_t& acc, uint32_t a, uint32_t b) {
  asm volatile("mad.hi.cc.u32 %0, %1, %2, %0;" : "+r"(acc) : "r"(a), "r"(b));
}
__device__ __forceinline__ void madc_hi_cc(uint32_t& acc, uint32_t a, uint32_t b) {
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %0;" : "+r"(acc) : "r"(a), "r"(b));
}
// d = lo(a*b) / hi(a*b) + c, with carry in and out
__device__ __forceinline__ void madc_lo_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t c) {
  asm volatile("madc.lo.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
}
__device__ __forceinline__ void madc_hi_cc(uint32_t& d, uint32_t a, uint32_t b, uint32_t c) {
  asm volatile("madc.hi.cc.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(b), "r"(c));
}

// ---- loads and stores of the half-limb layout ----

// Load 2*NW half-limbs (int32, each < 2^16) with element stride 1: 128-bit
// loads where the address is 16-byte aligned, else one word at a time.
template <int NW>
__device__ __forceinline__ Fe<NW> load_fe(const int32_t* src) {
  Fe<NW> r;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const int4* v = reinterpret_cast<const int4*>(src);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i) {
      const int4 q = v[i];
      r.w[2 * i] = __byte_perm((uint32_t)q.x, (uint32_t)q.y, 0x5410);
      r.w[2 * i + 1] = __byte_perm((uint32_t)q.z, (uint32_t)q.w, 0x5410);
    }
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i)
      r.w[i] = (uint32_t)src[2 * i] | ((uint32_t)src[2 * i + 1] << 16);
  }
  return r;
}

template <int NW>
__device__ __forceinline__ void store_fe(int32_t* dst, const Fe<NW>& a) {
  if ((reinterpret_cast<uintptr_t>(dst) & 15) == 0) {
    int4* v = reinterpret_cast<int4*>(dst);
#pragma unroll
    for (int i = 0; i < NW / 2; ++i)
      v[i] = make_int4((int32_t)(a.w[2 * i] & 0xFFFFu), (int32_t)(a.w[2 * i] >> 16),
                       (int32_t)(a.w[2 * i + 1] & 0xFFFFu), (int32_t)(a.w[2 * i + 1] >> 16));
  } else {
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      dst[2 * i] = (int32_t)(a.w[i] & 0xFFFFu);
      dst[2 * i + 1] = (int32_t)(a.w[i] >> 16);
    }
  }
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_const(const uint32_t* c) {
  Fe<NW> r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = c[i];
  return r;
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_zero() {
  Fe<NW> r;
#pragma unroll
  for (int i = 0; i < NW; ++i) r.w[i] = 0;
  return r;
}

template <int NW>
__device__ __forceinline__ bool fe_is_zero(const Fe<NW>& a) {
  uint32_t acc = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) acc |= a.w[i];
  return acc == 0;
}

// ---- word add / subtract ----

// r = a - b over NW words; returns the final borrow (0 or 1).
template <int NW>
__device__ __forceinline__ uint32_t sub_words(Fe<NW>& r, const Fe<NW>& a, const uint32_t* b) {
  sub_cc(r.w[0], a.w[0], b[0]);
#pragma unroll
  for (int i = 1; i < NW; ++i) subc_cc(r.w[i], a.w[i], b[i]);
  uint32_t borrow;
  subc(borrow, 0, 0);
  return borrow & 1;
}

// r = a + b over NW words; returns the carry out.
template <int NW>
__device__ __forceinline__ uint32_t add_words(Fe<NW>& r, const Fe<NW>& a, const uint32_t* b) {
  add_cc(r.w[0], a.w[0], b[0]);
#pragma unroll
  for (int i = 1; i < NW; ++i) addc_cc(r.w[i], a.w[i], b[i]);
  uint32_t carry;
  addc(carry, 0, 0);
  return carry;
}

// t (with an optional top word) minus m if that does not go negative:
// t in [0, 2m) -> t mod m.
template <int NW>
__device__ __forceinline__ Fe<NW> cond_sub(const Fe<NW>& t, uint32_t top, const uint32_t* m) {
  Fe<NW> d;
  uint32_t borrow = sub_words<NW>(d, t, m);
  return (top != 0 || borrow == 0) ? d : t;
}

template <int NW>
__device__ __forceinline__ Fe<NW> cond_sub_p(const Fe<NW>& t, uint32_t top, const FieldConsts& fc) {
  return cond_sub<NW>(t, top, fc.p);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_add(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  Fe<NW> s;
  uint32_t c = add_words<NW>(s, a, b.w);
  return cond_sub_p<NW>(s, c, fc);
}

// a - b, plus m where that borrows.
template <int NW>
__device__ __forceinline__ Fe<NW> sub_mod(const Fe<NW>& a, const Fe<NW>& b, const uint32_t* m) {
  Fe<NW> d;
  uint32_t borrow = sub_words<NW>(d, a, b.w);
  if (borrow) {
    Fe<NW> w;
    add_words<NW>(w, d, m);
    return w;
  }
  return d;
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_sub(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  return sub_mod<NW>(a, b, fc.p);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_dbl(const Fe<NW>& a, const FieldConsts& fc) {
  return fe_add<NW>(a, a, fc);
}

// ---- Montgomery product ----

// t[0 .. NB+1] += a * b[0 .. NB-1]: the low halves in one chain, the high
// halves one word up in a second.
template <int NB>
__device__ __forceinline__ void mac_row(uint32_t (&t)[NB + 2], uint32_t a, const uint32_t (&b)[NB]) {
  mad_lo_cc(t[0], a, b[0]);
#pragma unroll
  for (int j = 1; j < NB; ++j) madc_lo_cc(t[j], a, b[j]);
  addc_cc(t[NB], t[NB], 0);
  addc(t[NB + 1], t[NB + 1], 0);
  mad_hi_cc(t[1], a, b[0]);
#pragma unroll
  for (int j = 1; j < NB; ++j) madc_hi_cc(t[j + 1], a, b[j]);
  addc(t[NB + 1], t[NB + 1], 0);
}

// One reduction row: t = (t + m*p) / 2^32 with m = t[0] * n'.
template <int NB>
__device__ __forceinline__ void redc_row(uint32_t (&t)[NB + 2], const uint32_t* p, uint32_t np) {
  const uint32_t m = t[0] * np;
  mac_row<NB>(t, m, *reinterpret_cast<const uint32_t(*)[NB]>(p));
#pragma unroll
  for (int j = 0; j <= NB; ++j) t[j] = t[j + 1];
  t[NB + 1] = 0;
}

// Word-serial CIOS Montgomery product of NA words of a and NB words of b:
// returns the NB low words of u = (a*b + M*p) / 2^(32*NA), where M < 2^(32*NA)
// is the unique multiplier making the numerator divisible; t[NB] gets the
// word above.  With NA = NB this is the field product before its final
// subtract; with NA = 9, NB = 8 it is the 2^288-radix product of the
// digit-NTT twiddle (K2).
template <int NA, int NB>
__device__ __forceinline__ void cios(uint32_t (&t)[NB + 2], const uint32_t (&a)[NA],
                                     const uint32_t (&b)[NB], const uint32_t* p, uint32_t np) {
#pragma unroll
  for (int j = 0; j < NB + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    mac_row<NB>(t, a[i], b);
    redc_row<NB>(t, p, np);
  }
}

// The even/odd form of the CIOS product (N words, N even).  An accumulator
// T = even + 2^32 * odd is kept as two arrays: `even` takes the products of
// the even words of a (lo and hi of a_j * b_i at words j, j + 1, one
// carry chain), `odd` those of the odd words, one word up.  Each chain
// pairs the two halves of one 64-bit product on adjacent words, and the two
// chains are independent of each other.  After the reduction word 0 is
// zero; the shift by one word swaps the arrays' roles (odd becomes the even
// frame, even shifted by two words the odd frame), so the rows alternate
// between the two arrays and no word moves.

// acc[j], acc[j + 1] = a[j] * bi for even j.
template <int N>
__device__ __forceinline__ void eo_mul_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N; j += 2) {
    acc[j] = a[j] * bi;
    acc[j + 1] = __umulhi(a[j], bi);
  }
}

// acc += sum over even j of a[j] * bi * 2^(32 j); the carry out of word N-1
// is left in the carry flag.
template <int N>
__device__ __forceinline__ void eo_cmad_n(uint32_t* acc, const uint32_t* a, uint32_t bi) {
  mad_lo_cc(acc[0], a[0], bi);
  madc_hi_cc(acc[1], a[0], bi);
#pragma unroll
  for (int j = 2; j < N; j += 2) {
    madc_lo_cc(acc[j], a[j], bi);
    madc_hi_cc(acc[j + 1], a[j], bi);
  }
}

// odd = (odd >> 64 bits) + sum over even j of a[j] * bi * 2^(32 j), with
// the carry flag coming in at word 0.
template <int N>
__device__ __forceinline__ void eo_madc_rshift(uint32_t* odd, const uint32_t* a, uint32_t bi) {
#pragma unroll
  for (int j = 0; j < N - 2; j += 2) {
    madc_lo_cc(odd[j], a[j], bi, odd[j + 2]);
    madc_hi_cc(odd[j + 1], a[j], bi, odd[j + 3]);
  }
  odd[N - 2] = 0;
  odd[N - 1] = 0;
  madc_lo_cc(odd[N - 2], a[N - 2], bi);
  madc_hi_cc(odd[N - 1], a[N - 2], bi);
}

// One row: T += a * bi, then T = (T + m p) / 2^32 (the shift is the caller
// swapping `even` and `odd`).
template <int N>
__device__ __forceinline__ void eo_row(uint32_t* even, uint32_t* odd, const uint32_t* a, uint32_t bi,
                                       const uint32_t* p, uint32_t np, bool first) {
  if (first) {
    eo_mul_n<N>(odd, a + 1, bi);
    eo_mul_n<N>(even, a, bi);
  } else {
    add_cc(even[0], even[0], odd[1]);
    eo_madc_rshift<N>(odd, a + 1, bi);
    eo_cmad_n<N>(even, a, bi);
    addc(odd[N - 1], odd[N - 1], 0);
  }
  const uint32_t m = even[0] * np;
  eo_cmad_n<N>(odd, p + 1, m);
  eo_cmad_n<N>(even, p, m);
  addc(odd[N - 1], odd[N - 1], 0);
}

// (a*b + M*p) / R before its final subtract.  It is below 2p for
// canonical a, b (2p < R for every field of the port), and for a, b < 2p
// where 4p < R (the lazy domain), so it needs no word above N.
template <int NW>
__device__ __forceinline__ Fe<NW> mul_eo(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  uint32_t even[NW], odd[NW];
#pragma unroll
  for (int i = 0; i < NW; i += 2) {
    eo_row<NW>(even, odd, a.w, b.w[i], fc.p, fc.np, i == 0);
    eo_row<NW>(odd, even, a.w, b.w[i + 1], fc.p, fc.np, false);
  }
  Fe<NW> u;
  add_cc(u.w[0], even[0], odd[1]);
#pragma unroll
  for (int k = 1; k < NW - 1; ++k) addc_cc(u.w[k], even[k], odd[k + 1]);
  addc(u.w[NW - 1], even[NW - 1], 0);
  return u;
}

// a*b*R^-1 mod p, canonical.
template <int NW>
__device__ __forceinline__ Fe<NW> fe_mul(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  return cond_sub_p<NW>(mul_eo<NW>(a, b, fc), 0, fc);
}

// The square is the product with itself: on sm_90 the even/odd product
// (one IMAD.WIDE a word product) ran faster than a square that forms each
// cross product once in one carry chain.
template <int NW>
__device__ __forceinline__ Fe<NW> fe_sqr(const Fe<NW>& a, const FieldConsts& fc) {
  return fe_mul<NW>(a, a, fc);
}

// ---- lazy reduction: [0, 2p) -> [0, 2p) ----

template <int NW>
__device__ __forceinline__ Fe<NW> fe_mul_lazy(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  return mul_eo<NW>(a, b, fc);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_sqr_lazy(const Fe<NW>& a, const FieldConsts& fc) {
  return mul_eo<NW>(a, a, fc);
}

// a + b < 4p < R, so no word carries out; minus 2p where that fits.
template <int NW>
__device__ __forceinline__ Fe<NW> fe_add_lazy(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  Fe<NW> s;
  add_words<NW>(s, a, b.w);
  return cond_sub<NW>(s, 0, fc.p2);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_sub_lazy(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  return sub_mod<NW>(a, b, fc.p2);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_dbl_lazy(const Fe<NW>& a, const FieldConsts& fc) {
  return fe_add_lazy<NW>(a, a, fc);
}

// [0, 2p) -> the canonical value.
template <int NW>
__device__ __forceinline__ Fe<NW> fe_canon(const Fe<NW>& a, const FieldConsts& fc) {
  return cond_sub_p<NW>(a, 0, fc);
}

}  // namespace tec
