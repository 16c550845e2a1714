// Montgomery field arithmetic for a tile of T lanes that runs one chain of
// point ops (K3's chain entries, chain.cu).
//
// It computes what field.cuh's lazy and canonical functions compute, value
// for value (mul: the unreduced (ab + Mp)/R; add, sub, dbl in [0, 2p);
// canon; neg; is_zero), so any sequence of them is bit-identical to the
// same sequence of field.cuh calls, and so to tpu_ec's FieldOps; field.cuh's
// one-thread functions stay as they are for K1, K2, K4-K7 and K3's point
// kernel.
//
// mul_many takes a level of independent products and splits them across
// the lanes: lane k computes product k with field.cuh's one-thread
// even/odd product, and every lane receives every result (NW shuffles a
// product, independent of each other).  Every lane holds whole elements
// and runs the adds and subtracts itself, so the lanes hold equal values
// and take equal branches.  A point formula's critical path falls from its
// count of products (7 a doubling, 16 an add) to its count of levels (3,
// 5).  Tiles of one warp may take different branches: every shuffle names
// the tile's lanes only.
//
// TileProducts2 is the same core on Fq2 (G2's coordinates, c0 + c1 u):
// the lower half of the tile holds c0 of every value and runs its adds and
// subtracts, the upper half c1, so a lane holds one Fq element a value, as
// on G1.  An Fq2 product is 3 Fq products (a0 b0, a1 b1, (a0 + a1)(b0 +
// b1): c0 = aa - bb, c1 = o - aa - bb, the Karatsuba of tpu_ec's Fp2Ops,
// u^2 = -1 on both curves), each on a lane of its own: a tile of
// 16 lanes runs a level of up to 4 Fq2 products in one round (smaller
// tiles in rounds of T / 4).  Each lane's product in a level is fixed by
// its lane number, so it selects its operand from the level's (one
// candidate a product in the round); the lane of the third product takes
// its partner component from the lower half (2 NW shuffles), the lanes of
// c0 and c1 gather the other products (2 NW shuffles), and each half
// receives its component of each result (NW shuffles a product).  A zero
// test combines both halves.  A square goes through the same product.
#pragma once

#include <cooperative_groups.h>

#include "field.cuh"

namespace tec {

namespace cg = cooperative_groups;

// a - b, plus m where that borrows (field.cuh sub_mod's value), without a
// branch: tiles of one warp hold different values, and a data-dependent
// branch would split the warp.
template <int NW>
__device__ __forceinline__ Fe<NW> sub_masked(const Fe<NW>& a, const Fe<NW>& b, const uint32_t* m) {
  Fe<NW> d, w;
  const uint32_t mask = 0u - sub_words<NW>(d, a, b.w);
  add_cc(w.w[0], d.w[0], m[0] & mask);
#pragma unroll
  for (int i = 1; i < NW - 1; ++i) addc_cc(w.w[i], d.w[i], m[i] & mask);
  addc(w.w[NW - 1], d.w[NW - 1], m[NW - 1] & mask);
  return w;
}

// A level of independent products split across the lanes of a tile; every
// lane holds whole elements.
template <int NW, int T>
struct TileProducts {
  static_assert(NW % T == 0, "the tile size must divide the word count");
  static constexpr int kLanes = T;
  using E = Fe<NW>;

  cg::thread_block_tile<T> tile;
  const FieldConsts& fc;

  __device__ __forceinline__ TileProducts(const FieldConsts& c)
      : tile(cg::tiled_partition<T>(cg::this_thread_block())), fc(c) {}

  // r_k = a_k * b_k (lazy), in rounds of T: in a round lane j computes
  // product r0 + j (the last round's spare lanes repeat product r0), and
  // every lane receives each result.
  template <int N>
  __device__ __forceinline__ void mul_many(E (&r)[N], const E (&a)[N], const E (&b)[N]) const {
    const int lane = (int)tile.thread_rank();
#pragma unroll
    for (int r0 = 0; r0 < N; r0 += T) {
      E x = a[r0], y = b[r0];
#pragma unroll
      for (int k = r0 + 1; k < r0 + T && k < N; ++k) {
#pragma unroll
        for (int i = 0; i < NW; ++i) {
          x.w[i] = lane == k - r0 ? a[k].w[i] : x.w[i];
          y.w[i] = lane == k - r0 ? b[k].w[i] : y.w[i];
        }
      }
      const E z = mul_eo<NW>(x, y, fc);
#pragma unroll
      for (int k = r0; k < r0 + T && k < N; ++k) {
#pragma unroll
        for (int i = 0; i < NW; ++i) r[k].w[i] = tile.shfl(z.w[i], k - r0);
      }
    }
  }

  __device__ __forceinline__ E add(const E& a, const E& b) const { return fe_add_lazy<NW>(a, b, fc); }

  // a - b, plus 2p where that borrows, without a branch.
  __device__ __forceinline__ E sub(const E& a, const E& b) const { return sub_masked<NW>(a, b, fc.p2); }

  __device__ __forceinline__ E dbl(const E& a) const { return fe_dbl_lazy<NW>(a, fc); }

  __device__ __forceinline__ E canon(const E& a) const { return fe_canon<NW>(a, fc); }

  __device__ __forceinline__ E neg(const E& a) const { return sub_masked<NW>(zero(), a, fc.p); }

  static __device__ __forceinline__ E zero() { return fe_zero<NW>(); }

  // R mod p, the Montgomery one (an affine point's z).
  __device__ __forceinline__ E one() const { return fe_const<NW>(fc.one); }

  // Every lane holds the same value, so the test agrees across the tile.
  static __device__ __forceinline__ bool is_zero(const E& a) { return fe_is_zero<NW>(a); }

  static __device__ __forceinline__ E load(const int32_t* row) { return load_fe<NW>(row); }

  // Every lane stores the same value: a lane that reads the row back (the
  // EC-FFT stage's a - b) reads its own store.
  static __device__ __forceinline__ void store(int32_t* row, const E& a) { store_fe<NW>(row, a); }
};

// A level of independent Fq2 products split across the lanes of a tile:
// the lower half of the tile holds c0 of every Fq2 value, the upper half
// c1, so E is this lane's component.
template <int NW, int T>
struct TileProducts2 {
  static_assert(T >= 4 && T <= 32 && (T & (T - 1)) == 0, "a tile is 4 to 32 lanes, a power of two");
  static constexpr int kLanes = T;
  static constexpr int kHalf = T / 2;  // the lanes of one component
  static constexpr int kPer = T / 4;   // Fq2 products a round
  using E = Fe<NW>;

  cg::thread_block_tile<T> tile;
  const FieldConsts& fc;
  int lane;
  bool hi;  // this lane holds c1

  __device__ __forceinline__ TileProducts2(const FieldConsts& c)
      : tile(cg::tiled_partition<T>(cg::this_thread_block())), fc(c), lane((int)tile.thread_rank()),
        hi(lane >= kHalf) {}

  // r_k = a_k * b_k (lazy), kPer products a round; product j of a round on
  // lanes j (a0 b0), kHalf + j (a1 b1) and kHalf + kPer + j ((a0 + a1)(b0 +
  // b1), its a0 and b0 from lane kPer + j); lane j receives a1 b1 and forms
  // c0 = aa - bb, lane kHalf + kPer + j receives aa and bb and forms c1 = o -
  // aa - bb, and each half receives its component from them.
  template <int N>
  __device__ __forceinline__ void mul_many(E (&r)[N], const E (&a)[N], const E (&b)[N]) const {
    const int q = lane & (kHalf - 1);  // the lane's place in its half
    const int j = q & (kPer - 1);      // its product in a round
    const bool third = hi && q >= kPer;
#pragma unroll
    for (int k0 = 0; k0 < N; k0 += kPer) {
      E x = a[k0], y = b[k0];
#pragma unroll
      for (int k = k0 + 1; k < k0 + kPer && k < N; ++k) {
        x = pick(j == k - k0, a[k], x);
        y = pick(j == k - k0, b[k], y);
      }
      const E rx = xor_half(x), ry = xor_half(y);
      const E p = mul_eo<NW>(pick(third, add(x, rx), x), pick(third, add(y, ry), y), fc);
      E s1, s2;
#pragma unroll
      for (int i = 0; i < NW; ++i) {
        s1.w[i] = tile.shfl(p.w[i], (hi ? q - kPer : lane + kHalf) & (T - 1));
        s2.w[i] = tile.shfl(p.w[i], (kHalf + q - kPer) & (T - 1));
      }
      const E c01 = sub(p, s1);
      const E c = pick(third, sub(c01, s2), c01);
#pragma unroll
      for (int k = k0; k < k0 + kPer && k < N; ++k) {
#pragma unroll
        for (int i = 0; i < NW; ++i) r[k].w[i] = tile.shfl(c.w[i], hi ? kHalf + kPer + k - k0 : k - k0);
      }
    }
  }

  __device__ __forceinline__ E add(const E& a, const E& b) const { return fe_add_lazy<NW>(a, b, fc); }
  __device__ __forceinline__ E sub(const E& a, const E& b) const { return sub_masked<NW>(a, b, fc.p2); }
  __device__ __forceinline__ E dbl(const E& a) const { return fe_dbl_lazy<NW>(a, fc); }
  __device__ __forceinline__ E canon(const E& a) const { return fe_canon<NW>(a, fc); }
  __device__ __forceinline__ E neg(const E& a) const { return sub_masked<NW>(zero(), a, fc.p); }
  static __device__ __forceinline__ E zero() { return fe_zero<NW>(); }
  // this lane's component of the Fq2 one (R mod p, 0)
  __device__ __forceinline__ E one() const { return hi ? zero() : fe_const<NW>(fc.one); }

  // The Fq2 value is zero: both halves' components, so the tile agrees.
  __device__ __forceinline__ bool is_zero(const E& a) const {
    const int z = fe_is_zero<NW>(a);
    return (z & tile.shfl_xor(z, kHalf)) != 0;
  }

  // This lane's component of a row (c0, then c1).  Every lane of a half
  // stores the same value: a lane that reads the row back (the EC-FFT
  // stage's a - b) reads its own store.
  __device__ __forceinline__ E load(const int32_t* row) const { return load_fe<NW>(row + (hi ? 2 * NW : 0)); }
  __device__ __forceinline__ void store(int32_t* row, const E& a) const { store_fe<NW>(row + (hi ? 2 * NW : 0), a); }

 private:
  // the other half's component of what the lane kHalf away holds
  __device__ __forceinline__ E xor_half(const E& a) const {
    E r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = tile.shfl_xor(a.w[i], kHalf);
    return r;
  }
  static __device__ __forceinline__ E pick(bool take, const E& a, const E& b) {
    E r;
#pragma unroll
    for (int i = 0; i < NW; ++i) r.w[i] = take ? a.w[i] : b.w[i];
    return r;
  }
};

}  // namespace tec
