// Montgomery field arithmetic on 32-bit words, one element per thread.
//
// Shared by the three kernels (mont.cu, inter.cu, point.cu).  An element
// lives in NW 32-bit words (8 for 256-bit fields, 12 for BLS12-381 Fq),
// packed from the port's storage layout of 2*NW 16-bit half-limbs held in
// int32.  The Montgomery radix is R = 2^(32*NW) = 2^(16*L), the same R as
// the reference (tpu_ec/fields/params.py), so values cross over unchanged.
//
// The product is word-serial CIOS with n' = -p^-1 mod 2^32 (the reference
// CUDA/OpenCL field template, field.cl:268-299), carries in 64-bit
// accumulators.  Every function returns the canonical value (< p) for
// canonical inputs, so any sequence of these ops is bit-identical to the
// same sequence of tpu_ec FieldOps calls.
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
};

// Host layout of the constants: [np, p[0..11], one[0..11]] (25 words).
inline FieldConsts field_consts_from_host(const uint32_t* h) {
  FieldConsts fc;
  fc.np = h[0];
  for (int i = 0; i < kMaxWords; ++i) {
    fc.p[i] = h[1 + i];
    fc.one[i] = h[1 + kMaxWords + i];
  }
  return fc;
}

template <int NW>
struct Fe {
  uint32_t w[NW];
};

// Load 2*NW half-limbs (int32, each < 2^16) with element stride 1.
template <int NW>
__device__ __forceinline__ Fe<NW> load_fe(const int32_t* src) {
  Fe<NW> r;
#pragma unroll
  for (int i = 0; i < NW; ++i)
    r.w[i] = (uint32_t)src[2 * i] | ((uint32_t)src[2 * i + 1] << 16);
  return r;
}

template <int NW>
__device__ __forceinline__ void store_fe(int32_t* dst, const Fe<NW>& a) {
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    dst[2 * i] = (int32_t)(a.w[i] & 0xFFFFu);
    dst[2 * i + 1] = (int32_t)(a.w[i] >> 16);
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

// r = a - b over NW words; returns the final borrow (0 or 1).
template <int NW>
__device__ __forceinline__ uint32_t sub_words(Fe<NW>& r, const Fe<NW>& a, const uint32_t* b) {
  uint32_t borrow = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    uint64_t t = (uint64_t)a.w[i] - b[i] - borrow;
    r.w[i] = (uint32_t)t;
    borrow = (uint32_t)(t >> 63);
  }
  return borrow;
}

// r = a + b over NW words; returns the carry out.
template <int NW>
__device__ __forceinline__ uint32_t add_words(Fe<NW>& r, const Fe<NW>& a, const uint32_t* b) {
  uint64_t c = 0;
#pragma unroll
  for (int i = 0; i < NW; ++i) {
    c += (uint64_t)a.w[i] + b[i];
    r.w[i] = (uint32_t)c;
    c >>= 32;
  }
  return (uint32_t)c;
}

// t in [0, 2p) with an optional top word -> t mod p.
template <int NW>
__device__ __forceinline__ Fe<NW> cond_sub_p(const Fe<NW>& t, uint32_t top, const FieldConsts& fc) {
  Fe<NW> d;
  uint32_t borrow = sub_words<NW>(d, t, fc.p);
  return (top != 0 || borrow == 0) ? d : t;
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_add(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  Fe<NW> s;
  uint32_t c = add_words<NW>(s, a, b.w);
  return cond_sub_p<NW>(s, c, fc);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_sub(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  Fe<NW> d;
  uint32_t borrow = sub_words<NW>(d, a, b.w);
  if (borrow) {
    Fe<NW> w;
    add_words<NW>(w, d, fc.p);
    return w;
  }
  return d;
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_dbl(const Fe<NW>& a, const FieldConsts& fc) {
  return fe_add<NW>(a, a, fc);
}

// Word-serial CIOS Montgomery product of NA words of a and NB words of b:
// returns the NB low words of u = (a*b + M*p) / 2^(32*NA), where M < 2^(32*NA)
// is the unique multiplier making the numerator divisible; *top gets word NB.
// With NA = NB this is the field product before its final subtract; with
// NA = 9, NB = 8 it is the 2^288-radix product of the digit-NTT twiddle.
template <int NA, int NB>
__device__ __forceinline__ void cios(uint32_t (&t)[NB + 2], const uint32_t (&a)[NA],
                                     const uint32_t (&b)[NB], const uint32_t* p, uint32_t np) {
#pragma unroll
  for (int j = 0; j < NB + 2; ++j) t[j] = 0;
#pragma unroll
  for (int i = 0; i < NA; ++i) {
    uint64_t c = 0;
#pragma unroll
    for (int j = 0; j < NB; ++j) {
      uint64_t uv = (uint64_t)a[i] * b[j] + t[j] + c;
      t[j] = (uint32_t)uv;
      c = uv >> 32;
    }
    uint64_t uv = (uint64_t)t[NB] + c;
    t[NB] = (uint32_t)uv;
    t[NB + 1] = (uint32_t)(uv >> 32);
    uint32_t m = t[0] * np;
    uv = (uint64_t)m * p[0] + t[0];
    c = uv >> 32;
#pragma unroll
    for (int j = 1; j < NB; ++j) {
      uv = (uint64_t)m * p[j] + t[j] + c;
      t[j - 1] = (uint32_t)uv;
      c = uv >> 32;
    }
    uv = (uint64_t)t[NB] + c;
    t[NB - 1] = (uint32_t)uv;
    t[NB] = t[NB + 1] + (uint32_t)(uv >> 32);
  }
}

// a*b*R^-1 mod p, canonical.
template <int NW>
__device__ __forceinline__ Fe<NW> fe_mul(const Fe<NW>& a, const Fe<NW>& b, const FieldConsts& fc) {
  uint32_t t[NW + 2];
  cios<NW, NW>(t, a.w, b.w, fc.p, fc.np);
  Fe<NW> u;
#pragma unroll
  for (int i = 0; i < NW; ++i) u.w[i] = t[i];
  return cond_sub_p<NW>(u, t[NW], fc);
}

template <int NW>
__device__ __forceinline__ Fe<NW> fe_sqr(const Fe<NW>& a, const FieldConsts& fc) {
  return fe_mul<NW>(a, a, fc);
}

}  // namespace tec
