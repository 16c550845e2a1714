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
// TileProducts2 is the same core on Fq2 (G2's coordinates, field2.cuh's
// Fe2): a level of N Fq2 products is a level of 3N independent Fq products
// (a0 b0, a1 b1, (a0 + a1)(b0 + b1) each, the Karatsuba of field2.cuh),
// spread over the lanes in rounds as above; each lane forms its own
// product's operands (a lazy add, or a component as it is), so no lane
// holds the 3N operands at once, and each Fq2 result is combined as soon
// as its three products are in.  A square goes through the same product.
#pragma once

#include <cooperative_groups.h>

#include "field2.cuh"

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

// A level of independent Fq2 products split across the lanes of a tile;
// every lane holds whole Fq2 elements.
template <int NW, int T>
struct TileProducts2 {
  using Base = TileProducts<NW, T>;
  using E = Fe2<NW>;
  using Fq = Fe<NW>;

  Base base;

  __device__ __forceinline__ TileProducts2(const FieldConsts& c) : base(c) {}

  // r_k = a_k * b_k (lazy): the Fq products q = 3k + m, m = 0: a0 b0, 1:
  // a1 b1, 2: (a0 + a1)(b0 + b1), in rounds of T, lane j computing q = r0 +
  // j (the last round's spare lanes repeat q = r0); every lane receives
  // each result, and r_k is formed in the round that completes its three.
  template <int N>
  __device__ __forceinline__ void mul_many(E (&r)[N], const E (&a)[N], const E (&b)[N]) const {
    const int lane = (int)base.tile.thread_rank();
    Fq z[3 * N];
#pragma unroll
    for (int r0 = 0; r0 < 3 * N; r0 += T) {
      // lane's operands: x = xa + xb, y = ya + yb (lazy adds; xb = 0 unless m = 2)
      Fq xa = a[r0 / 3].c0, ya = b[r0 / 3].c0, xb = Base::zero(), yb = Base::zero();
      pick(xa, ya, xb, yb, a[r0 / 3], b[r0 / 3], r0 % 3, true);
#pragma unroll
      for (int q = r0 + 1; q < r0 + T && q < 3 * N; ++q) pick(xa, ya, xb, yb, a[q / 3], b[q / 3], q % 3, lane == q - r0);
      const Fq p = mul_eo<NW>(base.add(xa, xb), base.add(ya, yb), base.fc);
#pragma unroll
      for (int q = r0; q < r0 + T && q < 3 * N; ++q) {
#pragma unroll
        for (int i = 0; i < NW; ++i) z[q].w[i] = base.tile.shfl(p.w[i], q - r0);
      }
#pragma unroll
      for (int k = 0; k < N; ++k) {
        if (3 * k + 2 >= r0 && 3 * k + 2 < r0 + T) {
          const Fq& aa = z[3 * k];
          const Fq& bb = z[3 * k + 1];
          r[k] = E{base.sub(aa, bb), base.sub(base.sub(z[3 * k + 2], aa), bb)};
        }
      }
    }
  }

  __device__ __forceinline__ E add(const E& a, const E& b) const { return E{base.add(a.c0, b.c0), base.add(a.c1, b.c1)}; }
  __device__ __forceinline__ E sub(const E& a, const E& b) const { return E{base.sub(a.c0, b.c0), base.sub(a.c1, b.c1)}; }
  __device__ __forceinline__ E dbl(const E& a) const { return E{base.dbl(a.c0), base.dbl(a.c1)}; }
  __device__ __forceinline__ E canon(const E& a) const { return E{base.canon(a.c0), base.canon(a.c1)}; }
  __device__ __forceinline__ E neg(const E& a) const { return E{base.neg(a.c0), base.neg(a.c1)}; }
  static __device__ __forceinline__ E zero() { return E{Base::zero(), Base::zero()}; }
  static __device__ __forceinline__ bool is_zero(const E& a) { return Base::is_zero(a.c0) && Base::is_zero(a.c1); }
  static __device__ __forceinline__ E load(const int32_t* row) { return Ext2<NW>::load(row); }
  static __device__ __forceinline__ void store(int32_t* row, const E& a) { Ext2<NW>::store(row, a); }

 private:
  // Where `take`: the operands of Fq product m of (a, b) (branch-free
  // selects: tiles of one warp hold different values).
  static __device__ __forceinline__ void pick(Fq& xa, Fq& ya, Fq& xb, Fq& yb, const E& a, const E& b, int m,
                                              bool take) {
    const Fq& sa = m == 1 ? a.c1 : a.c0;
    const Fq& sb = m == 1 ? b.c1 : b.c0;
#pragma unroll
    for (int i = 0; i < NW; ++i) {
      xa.w[i] = take ? sa.w[i] : xa.w[i];
      ya.w[i] = take ? sb.w[i] : ya.w[i];
      xb.w[i] = take ? (m == 2 ? a.c1.w[i] : 0u) : xb.w[i];
      yb.w[i] = take ? (m == 2 ? b.c1.w[i] : 0u) : yb.w[i];
    }
  }
};

}  // namespace tec
