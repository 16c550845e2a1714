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
// 42-step carry: 2^26 columns take 1.23 ms of the card's IMAD rate against
// 2.02 ms of bytes, so the product has to run under the memory traffic.
//
// The int32 entry (inter_kernel): one thread per column.  Column reads are
// coalesced (the layout is digit-major, column-minor, as the GEMM leaves
// it), 128 bytes a warp a digit row.  The value is carried serially into
// 7-bit digits and placed straight into 9 words (288 = 9*32); the product
// is field.cuh's CIOS with NA = 9 words of v and NB = 8 words of T' and p,
// so the radix is 2^288 and the word n' is the field's own -p^-1 mod 2^32.
//
// The int8 entry (inter_i8_kernel), the final pass of a chunked transform:
// (37, n) digits in, canonical (n, 16) rows out.  Read as the int32 entry
// reads, one byte a thread a digit row, a warp asked for 32 bytes per load,
// and each thread wrote its 64-byte row as four 16-byte stores at a 64-byte
// stride, so one store instruction of a warp touched 32 sectors; the kernel
// ran at 2.13x its bytes bound.  Here a block takes tiles of kI8Tile
// columns, one thread a column: (1) a tile's (37, kI8Tile) digits come
// into shared memory by cp.async in 16-byte pieces, the rows of a tile
// being contiguous runs of kI8Tile bytes; (2) each thread packs its column
// from shared memory (digits < 128 carry nothing, so v is the digits side
// by side) and multiplies; (3) the block stages its output in shared
// memory and writes it out coalesced: the rows of a tile are one
// contiguous range of kI8Tile x 64 bytes, written 16 bytes a thread by
// consecutive threads (the staging buffer's 16-byte pieces are swizzled so
// that neither side conflicts on banks); planes (16, n) are written
// straight, 128 bytes a warp a plane; int8 digits out are staged too and
// written in 16-byte pieces.  With those loads and stores and the CIOS
// product the kernel took 3.12 ms at (37, 2^26), 1.54x its bound, planes
// as rows, and a grid that keeps the next tile's digits in flight while
// it computes one did no better (3.31 ms): the product's instructions,
// not the memory, set the time (the int32 entry hides the same product
// under 2.6x the bytes).  So the final pass's case, one twiddle for every
// column and a canonical result, takes a product with fewer word products
// (const_twiddle_product below: 9 x 8 + 2 x 8 against the CIOS's
// 9 x 8 + 9 x 8), 2.55 ms, 1.26x the bound; its nine constants are
// computed once a block, so the grid is what fits on the card at once,
// each block walking over tiles with two digit buffers (one tile a block:
// 3.18 ms).  Tiles of 128 and 64 columns took 2.63 and 3.04 ms (NVIDIA
// H100 80GB HBM3, 700.00 W; tpu_ec_torch/utils/inter_probe.py).  Loads and
// stores are streaming (evict-first): nothing is read twice.  A ragged
// last tile, or n not a multiple of 16, takes byte loads and stores.
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

__global__ void inter_kernel(const int32_t* __restrict__ cols, int dc, const int32_t* __restrict__ t16,
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

constexpr int kI8Tile = 256;  // columns a tile, one a thread (a multiple of 16)
static_assert(kI8Tile % 16 == 0 && kI8Tile <= 256,
              "whole 16-byte pieces of a digit row, within 48 KB of static shared memory");
constexpr int kDigBytes = kCarryDigits * kI8Tile;  // one tile's digit buffer
constexpr int kRowPieces = 4;                      // 16-byte pieces of an output row

__device__ __forceinline__ void copy16_async(void* smem, const void* gmem) {
  const uint32_t dst = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(dst), "l"(gmem));
}

__device__ __forceinline__ void copy_commit() { asm volatile("cp.async.commit_group;" ::: "memory"); }

// wait until at most `pending` of this thread's newest copy groups are in flight
template <int pending>
__device__ __forceinline__ void copy_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(pending) : "memory");
}

// a tile's digits whole in 16-byte pieces: every row of it starts on 16 bytes
__device__ __forceinline__ bool whole_tile(const int8_t* cols, long long n, int cnt) {
  return cnt == kI8Tile && (n & 15) == 0 && (reinterpret_cast<uintptr_t>(cols) & 15) == 0;
}

// start bringing tile t's (dc, cnt) digits into `dig`: cp.async where the
// tile is whole, else byte loads (done when they return)
__device__ __forceinline__ void fetch_tile(uint8_t* dig, const int8_t* __restrict__ cols, int dc, long long n,
                                           long long t) {
  const long long c0 = t * kI8Tile;
  const int cnt = (int)min((long long)kI8Tile, n - c0);
  if (whole_tile(cols, n, cnt)) {
    constexpr int per_row = kI8Tile / 16;
    for (int q = threadIdx.x; q < dc * per_row; q += kI8Tile) {
      const int e = q / per_row, c = q - e * per_row;
      copy16_async(dig + e * kI8Tile + c * 16, cols + (long long)e * n + c0 + c * 16);
    }
  } else {
    for (int q = threadIdx.x; q < dc * cnt; q += kI8Tile) {
      const int e = q / cnt, c = q - e * cnt;
      dig[e * kI8Tile + c] = (uint8_t)cols[(long long)e * n + c0 + c];
    }
  }
  copy_commit();
}

// the staging slot of 16-byte piece c of output row j: the pieces of a row
// are permuted by (j / 2) % 4, so the 8 threads of a 128-byte phase hit 8
// different 16-byte bank groups when each writes piece c of its own row,
// and when 8 consecutive threads read 8 consecutive pieces
__device__ __forceinline__ int stage_slot(int j, int c) { return j * kRowPieces + (c ^ ((j >> 1) & 3)); }

// The canonical product by one twiddle for every column.  u = v T' / 2^288
// mod p is S 2^-64 mod p with S = sum_k v_k C_k, C_k = T' 2^(32 (k - 7))
// mod p (k = 0 .. 8, v_k the words of v): nine one-word-by-eight-word
// products into one accumulator (S < 9 2^32 p < 2^291) and two rows of
// Montgomery reduction leave S 2^-64 < 2^227 + p < 2p, one subtract from
// canonical.  That is 9 x 8 + 2 x 8 word products against the CIOS's
// 9 x 8 + 9 x 8, and the canonical value is the CIOS's exactly (u < 2p, one
// subtract).  The C_k are computed once a block into shared memory: C_7 is
// T' (made canonical), C_k one reduction row below C_(k+1), C_8 C_7 doubled
// 32 times.
__device__ __forceinline__ void twiddle_words(uint32_t (*C)[8], const int32_t* t16, const tec::FieldConsts& fc) {
  constexpr int doubler = kI8Tile > 32 ? 32 : 1;  // another warp where there is one
  if (threadIdx.x != 0 && threadIdx.x != doubler) return;
  tec::Fe<8> c = tec::cond_sub_p<8>(tec::load_fe<8>(t16), 0, fc);
  if (threadIdx.x == 0) {
#pragma unroll 1
    for (int k = 7; k >= 0; --k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) C[k][j] = c.w[j];
      uint32_t t[10];
#pragma unroll
      for (int j = 0; j < 8; ++j) t[j] = c.w[j];
      t[8] = t[9] = 0;
      tec::redc_row<8>(t, fc.p, fc.np);  // (c + m p) / 2^32 <= p
#pragma unroll
      for (int j = 0; j < 8; ++j) c.w[j] = t[j];
      c = tec::cond_sub_p<8>(c, t[8], fc);
    }
  } else {
#pragma unroll 1
    for (int k = 0; k < 32; ++k) c = tec::fe_dbl<8>(c, fc);
#pragma unroll
    for (int j = 0; j < 8; ++j) C[8][j] = c.w[j];
  }
}

// S 2^-64 mod p (canonical) for S = sum_k v_k C_k
__device__ __forceinline__ tec::Fe<8> const_twiddle_product(const uint32_t (&v)[kWideWords],
                                                            const uint32_t (*C)[8], const tec::FieldConsts& fc) {
  uint32_t t[10];
#pragma unroll
  for (int j = 0; j < 10; ++j) t[j] = 0;
#pragma unroll
  for (int k = 0; k < kWideWords; ++k) {
    uint32_t ck[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) ck[j] = C[k][j];
    tec::mac_row<8>(t, v[k], ck);
  }
  tec::redc_row<8>(t, fc.p, fc.np);
  tec::redc_row<8>(t, fc.p, fc.np);
  tec::Fe<8> r;
#pragma unroll
  for (int j = 0; j < 8; ++j) r.w[j] = t[j];
  return tec::cond_sub_p<8>(r, t[8], fc);
}

__global__ void __launch_bounds__(kI8Tile) inter_i8_kernel(const int8_t* __restrict__ cols, int dc,
                                                          const int32_t* __restrict__ t16, int t_const,
                                                          long long t_rep, void* __restrict__ out, int canonical,
                                                          int out_rows, long long n, tec::FieldConsts fc) {
  __shared__ __align__(16) uint8_t dig[2][kDigBytes];          // two tiles' digits: this one, the next
  __shared__ __align__(16) int4 stage[kI8Tile * kRowPieces];   // the output, rows or digits
  __shared__ __align__(16) uint32_t tw_words[kWideWords][8];   // the C_k of one twiddle for every column
  const int tid = threadIdx.x;
  const long long tiles = (n + kI8Tile - 1) / kI8Tile;
  long long t = blockIdx.x;
  if (t >= tiles) return;
  fetch_tile(dig[0], cols, dc, n, t);
  const bool const_canonical = t_const && canonical;
  if (const_canonical) twiddle_words(tw_words, t16, fc);  // read after the loop's first barrier
  for (int b = 0; t < tiles; t += gridDim.x, b ^= 1) {
    if (t + gridDim.x < tiles) {  // the next tile's digits come in while this one computes
      fetch_tile(dig[b ^ 1], cols, dc, n, t + gridDim.x);
      copy_wait<1>();
    } else {
      copy_wait<0>();
    }
    __syncthreads();
    const long long c0 = t * kI8Tile, i = c0 + tid;
    const int cnt = (int)min((long long)kI8Tile, n - c0);
    tec::Fe<8> r;
    uint32_t u[10];
    if (tid < cnt) {
      // digits < 128: no carry, v is the 7-bit digits side by side, mod 2^288
      uint32_t v[kWideWords];
#pragma unroll
      for (int k = 0; k < kWideWords; ++k) v[k] = 0;
#pragma unroll
      for (int e = 0; e < kCarryDigits; ++e) {
        if (e < dc) {
          const uint32_t d = dig[b][e * kI8Tile + tid];
          const int bit = e * kDigitBits, w = bit >> 5, off = bit & 31;
          if (w < kWideWords) v[w] |= d << off;
          if (off > 32 - kDigitBits && w + 1 < kWideWords) v[w + 1] |= d >> (32 - off);
        }
      }
      if (const_canonical) {
        r = const_twiddle_product(v, tw_words, fc);
      } else {
        const long long row = t_const ? 0 : (t_rep == 1 ? i : i / t_rep);
        const tec::Fe<8> f = tec::load_fe<8>(t16 + row * 16);
        uint32_t tw[8];
#pragma unroll
        for (int k = 0; k < 8; ++k) tw[k] = f.w[k];
        tec::cios<kWideWords, 8>(u, v, tw, fc.p, fc.np);
#pragma unroll
        for (int k = 0; k < 8; ++k) r.w[k] = u[k];
        if (canonical) r = tec::cond_sub_p<8>(r, u[8], fc);
      }
    }

    if (canonical && !out_rows) {  // (16, n) planes: 128 bytes a warp a plane
      if (tid < cnt) {
        int32_t* o = (int32_t*)out;
#pragma unroll
        for (int k = 0; k < 8; ++k) {
          __stcs(o + (long long)(2 * k) * n + i, (int32_t)(r.w[k] & 0xFFFFu));
          __stcs(o + (long long)(2 * k + 1) * n + i, (int32_t)(r.w[k] >> 16));
        }
      }
    } else if (canonical) {  // (n, 16) rows: the tile's rows are kI8Tile x 64 contiguous bytes
      if (tid < cnt) {
#pragma unroll
        for (int c = 0; c < kRowPieces; ++c)
          stage[stage_slot(tid, c)] = make_int4((int32_t)(r.w[2 * c] & 0xFFFFu), (int32_t)(r.w[2 * c] >> 16),
                                                (int32_t)(r.w[2 * c + 1] & 0xFFFFu),
                                                (int32_t)(r.w[2 * c + 1] >> 16));
      }
      __syncthreads();
      int4* o = reinterpret_cast<int4*>((int32_t*)out + c0 * 16);
      for (int q = tid; q < cnt * kRowPieces; q += kI8Tile) __stcs(o + q, stage[stage_slot(q >> 2, q & 3)]);
    } else {
      // 37 int8 digits of u (u < 2p < 2^256, the top word u[8] is 0), staged
      // as (37, kI8Tile) bytes, then written in 16-byte pieces where whole
      uint8_t* sd = reinterpret_cast<uint8_t*>(stage);
      if (tid < cnt) {
#pragma unroll
        for (int e = 0; e < kOutDigits; ++e) {
          const int bit = e * kDigitBits, w = bit >> 5, off = bit & 31;
          uint32_t d = u[w] >> off;
          if (off > 32 - kDigitBits && w + 1 < 8) d |= u[w + 1] << (32 - off);
          sd[e * kI8Tile + tid] = (uint8_t)(d & 127u);
        }
      }
      __syncthreads();
      int8_t* o = (int8_t*)out;
      if (whole_tile(o, n, cnt)) {
        constexpr int per_row = kI8Tile / 16;
        for (int q = tid; q < kOutDigits * per_row; q += kI8Tile) {
          const int e = q / per_row, c = q - e * per_row;
          __stcs(reinterpret_cast<int4*>(o + (long long)e * n + c0 + c * 16),
                 *reinterpret_cast<const int4*>(sd + e * kI8Tile + c * 16));
        }
      } else {
        for (int q = tid; q < kOutDigits * cnt; q += kI8Tile) {
          const int e = q / cnt, c = q - e * cnt;
          o[(long long)e * n + c0 + c] = (int8_t)sd[e * kI8Tile + c];
        }
      }
    }
    __syncthreads();  // this tile's digits and staged output are spent before they are refilled
  }
}

// the int8 kernel's grid: as many blocks as fit on the card at once, each
// walking over tiles (its next tile's digits in flight while it computes one),
// on the current device (two queries, cheap beside a launch)
unsigned i8_grid(long long tiles) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, inter_i8_kernel, kI8Tile, 0);
  const long long resident = (long long)sms * (per_sm > 0 ? per_sm : 1);
  return (unsigned)(tiles < resident ? tiles : resident);
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
    const unsigned grid = i8_grid((n + kI8Tile - 1) / kI8Tile);
    inter_i8_kernel<<<grid, kI8Tile, 0, s>>>((const int8_t*)cols, dc, (const int32_t*)t16, t_const, t_rep, out,
                                              canonical, out_rows, n, c);
  } else {
    inter_kernel<<<blocks, threads, 0, s>>>((const int32_t*)cols, dc, (const int32_t*)t16, t_const, t_rep, out,
                                            canonical, out_rows, n, c);
  }
  return (int)cudaGetLastError();
}
