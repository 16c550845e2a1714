// The coordinate fields of K3's point kernels: Fq (G1) and Fq2 (G2), as
// policy types that point.cu's formulas are written against.
//
// Fq2 = Fq[u]/(u^2 + 1) on both curves (tpu_ec/fields/fp2.py).  An element
// is two Fe<NW> (c0, c1); in device memory it is 2 * 2NW int32 half-limbs,
// c0 then c1, the port's (..., 2L) layout.  The product is the 3-product
// Karatsuba (aa = a0 b0, bb = a1 b1, c0 = aa - bb, c1 = (a0 + a1)(b0 + b1)
// - aa - bb) and the square (a0 + a1)(a0 - a1), 2 a0 a1: 3 and 2 Fq
// products.  Both stay in field.cuh's lazy domain [0, 2p): every sum and
// difference that feeds a product is a lazy add or subtract (never a raw
// sum, which could reach 4p), and a lazy product of two values below 2p is
// below 2p.  fe_canon on each component gives the canonical value, so the
// stored coordinates are bit-identical to tpu_ec's Fp2Ops (any exact
// evaluation of a product gives the same canonical residue).
//
// Ext1<NW> and Ext2<NW> have the same static interface: E, the lazy mul,
// sqr, add, sub, dbl, canon, is_zero, zero, one, and load / store of the
// half-limb layout.
#pragma once

#include "field.cuh"

namespace tec {

template <int NW>
struct Fe2 {
  Fe<NW> c0, c1;
};

// Fq: field.cuh's one-thread functions.
template <int NW>
struct Ext1 {
  using E = Fe<NW>;
  static constexpr int kExt = 1;
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

// Fq2 on the same functions, component by component.
template <int NW>
struct Ext2 {
  using E = Fe2<NW>;
  static constexpr int kExt = 2;
  static __device__ __forceinline__ E mul(const E& a, const E& b, const FieldConsts& fc) {
    const Fe<NW> aa = fe_mul_lazy<NW>(a.c0, b.c0, fc);
    const Fe<NW> bb = fe_mul_lazy<NW>(a.c1, b.c1, fc);
    const Fe<NW> o = fe_mul_lazy<NW>(fe_add_lazy<NW>(a.c0, a.c1, fc), fe_add_lazy<NW>(b.c0, b.c1, fc), fc);
    return E{fe_sub_lazy<NW>(aa, bb, fc), fe_sub_lazy<NW>(fe_sub_lazy<NW>(o, aa, fc), bb, fc)};
  }
  static __device__ __forceinline__ E sqr(const E& a, const FieldConsts& fc) {
    const Fe<NW> ab = fe_mul_lazy<NW>(a.c0, a.c1, fc);
    const Fe<NW> c0 = fe_mul_lazy<NW>(fe_add_lazy<NW>(a.c0, a.c1, fc), fe_sub_lazy<NW>(a.c0, a.c1, fc), fc);
    return E{c0, fe_dbl_lazy<NW>(ab, fc)};
  }
  static __device__ __forceinline__ E add(const E& a, const E& b, const FieldConsts& fc) {
    return E{fe_add_lazy<NW>(a.c0, b.c0, fc), fe_add_lazy<NW>(a.c1, b.c1, fc)};
  }
  static __device__ __forceinline__ E sub(const E& a, const E& b, const FieldConsts& fc) {
    return E{fe_sub_lazy<NW>(a.c0, b.c0, fc), fe_sub_lazy<NW>(a.c1, b.c1, fc)};
  }
  static __device__ __forceinline__ E dbl(const E& a, const FieldConsts& fc) {
    return E{fe_dbl_lazy<NW>(a.c0, fc), fe_dbl_lazy<NW>(a.c1, fc)};
  }
  static __device__ __forceinline__ E canon(const E& a, const FieldConsts& fc) {
    return E{fe_canon<NW>(a.c0, fc), fe_canon<NW>(a.c1, fc)};
  }
  static __device__ __forceinline__ bool is_zero(const E& a) {
    return fe_is_zero<NW>(a.c0) && fe_is_zero<NW>(a.c1);
  }
  static __device__ __forceinline__ E zero() { return E{fe_zero<NW>(), fe_zero<NW>()}; }
  static __device__ __forceinline__ E one(const FieldConsts& fc) { return E{fe_const<NW>(fc.one), fe_zero<NW>()}; }
  static __device__ __forceinline__ E load(const int32_t* src) {
    return E{load_fe<NW>(src), load_fe<NW>(src + 2 * NW)};
  }
  static __device__ __forceinline__ void store(int32_t* dst, const E& a) {
    store_fe<NW>(dst, a.c0);
    store_fe<NW>(dst + 2 * NW, a.c1);
  }
};

}  // namespace tec
