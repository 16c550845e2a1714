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
#pragma once

#include <cooperative_groups.h>

#include "field.cuh"

namespace tec {

namespace cg = cooperative_groups;

// A level of independent products split across the lanes of a tile; every
// lane holds whole elements.
template <int NW, int T>
struct TileProducts {
  static_assert(NW % T == 0, "the tile size must divide the word count");
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

  // a - b, plus 2p where that borrows, without a branch: tiles of one warp
  // hold different values, and a data-dependent branch would split the warp.
  __device__ __forceinline__ E sub(const E& a, const E& b) const { return sub_masked(a, b, fc.p2); }

  __device__ __forceinline__ E dbl(const E& a) const { return fe_dbl_lazy<NW>(a, fc); }

  __device__ __forceinline__ E canon(const E& a) const { return fe_canon<NW>(a, fc); }

  __device__ __forceinline__ E neg(const E& a) const { return sub_masked(zero(), a, fc.p); }

  static __device__ __forceinline__ E zero() { return fe_zero<NW>(); }

  // Every lane holds the same value, so the test agrees across the tile.
  static __device__ __forceinline__ bool is_zero(const E& a) { return fe_is_zero<NW>(a); }

  static __device__ __forceinline__ E load(const int32_t* row) { return load_fe<NW>(row); }

  // Every lane stores the same value: a lane that reads the row back (the
  // EC-FFT stage's a - b) reads its own store.
  static __device__ __forceinline__ void store(int32_t* row, const E& a) { store_fe<NW>(row, a); }

 private:
  // a - b, plus m where that borrows (field.cuh sub_mod's value).
  static __device__ __forceinline__ E sub_masked(const E& a, const E& b, const uint32_t* m) {
    E d, w;
    const uint32_t mask = 0u - sub_words<NW>(d, a, b.w);
    add_cc(w.w[0], d.w[0], m[0] & mask);
#pragma unroll
    for (int i = 1; i < NW - 1; ++i) addc_cc(w.w[i], d.w[i], m[i] & mask);
    addc(w.w[NW - 1], d.w[NW - 1], m[NW - 1] & mask);
    return w;
  }
};

}  // namespace tec
