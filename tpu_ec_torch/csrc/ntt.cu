// K4: block-resident leaf NTT (the fused NTT's leaves and their level
// epilogue) and K5: the constant-geometry (Pease) NTT stages.
//
// K4 replaces tpu_ec/ops/pallas/ntt_fused.py:_leaf_call (and
// _leaf_call_list) together with the bit-reversal gather of _leaf_apply: a
// whole 2^R-point decimation-in-frequency NTT per column, natural order out.
// Its optional level epilogue also does what tpu_ec's _rec does after the
// leaf (_twiddle_mul by the level table, then the transpose).
// K5 replaces tpu_ec/ops/pallas/ntt.py:_butterfly_call together with the
// stage's twiddle broadcast and interleave: (a, b) -> (a + b, (a - b) * w^e)
// with e = (i >> s) << s, stored interleaved, for a range of stages, with
// the final bit reversal folded into the store.  Every field op is
// canonical, so both are bit-identical to tpu_ec's stages.
//
// Bound on the H100: integer-ALU for both.  A butterfly is one 256-bit
// product (2*8*8 + 8 = 136 32x32->64 multiply-adds) against 64 bytes of
// traffic per element pair and pass through device memory; with all of a
// row's stages (K5) or a leaf's stages (K4) in one launch the products
// outweigh the bytes several times over.
//
// Design.  Both kernels stage their tile in shared memory once, as word
// planes (word k of tile element i at [k * stride + pad(i)]), so a warp
// that reads consecutive elements reads 32 banks; one pad word every 32
// keeps stride-2 and stride-4 accesses and the bit-reversed reads spread
// too.  Loads and stores to device memory are 16-byte vectors, neighbouring
// threads on neighbouring addresses; the half-limb pairs are packed into
// 32-bit words on the way in and split on the way out.
//
// K5 (pease_rows_kernel): a block holds R whole rows (R * n = 512 points,
// one row from n = 512 up) and the master table w^j, and runs stages
// s0 .. s1-1 between two buffers, one butterfly a thread a stage with a
// barrier between stages.  Rows too long for one block (the launcher asks
// pease_rows_fit) run one stage a launch in pease_stage_kernel, which reads
// and writes device memory directly.
//
// K4 (ntt_leaf_kernel): a block holds C adjacent columns (C * m = 1024
// points: C = 4 at leaf 8, more for smaller leaves), so each of the m rows
// of its tile is C * 64 contiguous bytes on Fr.  Each thread runs two DIF
// stages on 4 elements in registers (radix 4) between barriers, a radix-2
// stage last where R is odd; the stage twiddles the leaf uses (m - 1 of
// them) sit in shared memory once per block.  With the level epilogue the
// block multiplies natural row k2 of column c = j1 * B + b by T[k2, j1]
// and writes it at row (j1 * m + k2) * B + b: the layout the next level
// of the fused NTT reads, so no twiddle pass and no transpose follow.
#include "field.cuh"

namespace {

using tec::Fe;
using tec::FieldConsts;

constexpr int kThreads = 256;
constexpr int kRowsTile = 512;       // K5: points a block holds (R * n) below n = 512
constexpr int kLeafTile = 1024;      // K4: points a block holds (C * m)
constexpr int kMaxShared = 232448;   // dynamic shared memory a block may opt into (sm_90)

// Tile element i -> its word slot in a plane: one pad word every 32.
__device__ __forceinline__ int pad_idx(int i) { return i + (i >> 5); }

// Plane stride for `count` elements: the padded length rounded up to 4 mod
// 32, so the 8 elements x 4 word pairs that one warp's 16-byte loads bring
// in (Fr) land on 32 banks.
__host__ __device__ inline int plane_stride(int count) {
  const int p = count + (count >> 5);
  return p + ((36 - (p & 31)) & 31);
}

template <int NW>
__device__ __forceinline__ Fe<NW> ld_plane(const uint32_t* s, int stride, int i) {
  Fe<NW> r;
  const int pi = pad_idx(i);
#pragma unroll
  for (int k = 0; k < NW; ++k) r.w[k] = s[k * stride + pi];
  return r;
}

template <int NW>
__device__ __forceinline__ void st_plane(uint32_t* s, int stride, int i, const Fe<NW>& a) {
  const int pi = pad_idx(i);
#pragma unroll
  for (int k = 0; k < NW; ++k) s[k * stride + pi] = a.w[k];
}

// One 16-byte chunk of half-limbs (4 int32, each < 2^16) <-> two words.
__device__ __forceinline__ uint2 pack2(int4 q) {
  return make_uint2(__byte_perm((uint32_t)q.x, (uint32_t)q.y, 0x5410),
                    __byte_perm((uint32_t)q.z, (uint32_t)q.w, 0x5410));
}

__device__ __forceinline__ int4 unpack2(uint32_t a, uint32_t b) {
  return make_int4((int32_t)(a & 0xFFFFu), (int32_t)(a >> 16), (int32_t)(b & 0xFFFFu),
                   (int32_t)(b >> 16));
}

// Chunk q (word pair 2q, 2q + 1) of an element to and from its planes.
__device__ __forceinline__ void chunk_to_planes(uint32_t* s, int stride, int i, int q, int4 v) {
  const uint2 w = pack2(v);
  const int pi = pad_idx(i);
  s[(2 * q) * stride + pi] = w.x;
  s[(2 * q + 1) * stride + pi] = w.y;
}

__device__ __forceinline__ int4 chunk_from_planes(const uint32_t* s, int stride, int i, int q) {
  const int pi = pad_idx(i);
  return unpack2(s[(2 * q) * stride + pi], s[(2 * q + 1) * stride + pi]);
}

__device__ __forceinline__ int bit_rev(int i, int log_n) {
  return (int)(__brev((unsigned)i) >> (32 - log_n));
}

// ---- K5 ----

// Words of shared memory of one K5 block: two buffers of the rows' planes
// and the master table's planes.
__host__ __device__ inline int pease_rows_words(int nw, int log_n) {
  const int n = 1 << log_n;
  const int tile = n < kRowsTile ? kRowsTile : n;
  return nw * (2 * plane_stride(tile) + plane_stride(n >> 1));
}

// y, out: (batch, n, L) rows; tw: (n/2, L) master table w^j.  Block b takes
// rows b*R .. b*R + R - 1 (R = rows_per_block, the last block ragged).
template <int NW>
__global__ void __launch_bounds__(kThreads)
    pease_rows_kernel(const int32_t* __restrict__ y, const int32_t* __restrict__ tw,
                      int32_t* __restrict__ out, long long batch, int log_n, int rows_per_block,
                      int s0, int s1, int bitrev, FieldConsts fc) {
  using namespace tec;
  constexpr int L = 2 * NW;
  constexpr int Q4 = NW / 2;  // 16-byte chunks an element
  extern __shared__ uint32_t smem[];
  const int n = 1 << log_n;
  const int half = n >> 1;
  const long long row0 = (long long)blockIdx.x * rows_per_block;
  const int rows = (int)min((long long)rows_per_block, batch - row0);
  const int P = plane_stride(rows_per_block * n);
  const int PT = plane_stride(half);
  uint32_t* buf0 = smem;
  uint32_t* buf1 = smem + NW * P;
  uint32_t* tws = smem + 2 * NW * P;

  const int chunks = rows * n * Q4;
  const int4* src = reinterpret_cast<const int4*>(y + row0 * n * L);
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int e = c / Q4;
    chunk_to_planes(buf0, P, e, c - e * Q4, src[c]);
  }
  const int4* tsrc = reinterpret_cast<const int4*>(tw);
  for (int c = threadIdx.x; c < half * Q4; c += kThreads) {
    const int e = c / Q4;
    chunk_to_planes(tws, PT, e, c - e * Q4, tsrc[c]);
  }
  __syncthreads();

  uint32_t* cur = buf0;
  uint32_t* nxt = buf1;
  const int pairs = rows * half;
  for (int s = s0; s < s1; ++s) {
    for (int g = threadIdx.x; g < pairs; g += kThreads) {
      const int j = g & (half - 1);
      const int base = (g >> (log_n - 1)) << log_n;
      const Fe<NW> a = ld_plane<NW>(cur, P, base + j);
      const Fe<NW> b = ld_plane<NW>(cur, P, base + j + half);
      const Fe<NW> w = ld_plane<NW>(tws, PT, (j >> s) << s);
      st_plane<NW>(nxt, P, base + 2 * j, fe_add<NW>(a, b, fc));
      st_plane<NW>(nxt, P, base + 2 * j + 1, fe_mul<NW>(fe_sub<NW>(a, b, fc), w, fc));
    }
    __syncthreads();
    uint32_t* t = cur;
    cur = nxt;
    nxt = t;
  }

  int4* dst = reinterpret_cast<int4*>(out + row0 * n * L);
  for (int c = threadIdx.x; c < chunks; c += kThreads) {
    const int e = c / Q4;
    const int i = e & (n - 1);
    const int from = bitrev ? e - i + bit_rev(i, log_n) : e;
    dst[c] = chunk_from_planes(cur, P, from, c - e * Q4);
  }
}

// One stage straight from device memory, for rows too long for one block:
// one thread a butterfly, the outputs at their bit-reversed rows where
// bitrev is set (the last stage of a transform).
template <int NW>
__global__ void pease_stage_kernel(const int32_t* __restrict__ y, const int32_t* __restrict__ tw,
                                   int32_t* __restrict__ out, long long total, int log_n, int s,
                                   int bitrev, FieldConsts fc) {
  using namespace tec;
  constexpr int L = 2 * NW;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long half = 1LL << (log_n - 1);
  const long long b = i >> (log_n - 1);
  const int j = (int)(i & (half - 1));
  const int32_t* row = y + b * (2 * half) * L;
  Fe<NW> a = load_fe<NW>(row + j * L);
  Fe<NW> c = load_fe<NW>(row + (j + half) * L);
  Fe<NW> w = load_fe<NW>(tw + (long long)((j >> s) << s) * L);
  const int k0 = bitrev ? bit_rev(2 * j, log_n) : 2 * j;
  const int k1 = bitrev ? bit_rev(2 * j + 1, log_n) : 2 * j + 1;
  int32_t* o = out + b * (2 * half) * L;
  store_fe<NW>(o + (long long)k0 * L, fe_add<NW>(a, c, fc));
  store_fe<NW>(o + (long long)k1 * L, fe_mul<NW>(fe_sub<NW>(a, c, fc), w, fc));
}

template <int NW>
int launch_pease_rows(const int32_t* y, const int32_t* tw, int32_t* out, long long batch, int log_n,
                      int s0, int s1, int bitrev, const FieldConsts& fc, cudaStream_t st) {
  const int n = 1 << log_n;
  const int rows = n < kRowsTile ? kRowsTile / n : 1;
  const size_t shmem = (size_t)pease_rows_words(NW, log_n) * 4;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(pease_rows_kernel<NW>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const unsigned blocks = (unsigned)((batch + rows - 1) / rows);
  pease_rows_kernel<NW><<<blocks, kThreads, shmem, st>>>(y, tw, out, batch, log_n, rows, s0, s1,
                                                         bitrev, fc);
  return (int)cudaGetLastError();
}

// ---- K4 ----

__host__ __device__ inline int leaf_cols(int log_m) {
  const int c = kLeafTile >> log_m;
  return c < 1 ? 1 : c;
}

// Words of shared memory of one K4 block: the tile's planes and the stage
// twiddles' planes (stage s's m >> (s + 1) entries at m - (m >> s)).
__host__ __device__ inline int leaf_words(int nw, int log_m) {
  const int m = 1 << log_m;
  return nw * (plane_stride(leaf_cols(log_m) * m) + plane_stride(m - 1));
}

// x: (m, batch, L) columns along axis 0; tw: (log_m, m/2, L) DIF stage
// twiddles (stage s reads its first m >> (s + 1)).  LEVEL = 0: out is
// (m, batch, L), natural order.  LEVEL = 1: lvl is the (m, batch / B, L)
// level table T and out the (batch / B, m * B, L) next-level rows.
template <int NW, int LEVEL>
__global__ void __launch_bounds__(kThreads, NW == 8 ? 2 : 1)
    ntt_leaf_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
                    const int32_t* __restrict__ lvl, int32_t* __restrict__ out, int log_m,
                    long long batch, long long B, FieldConsts fc) {
  using namespace tec;
  constexpr int L = 2 * NW;
  constexpr int Q4 = NW / 2;
  extern __shared__ uint32_t smem[];
  const int m = 1 << log_m;
  const int cols = leaf_cols(log_m);
  const long long c0 = (long long)blockIdx.x * cols;
  const int ncol = (int)min((long long)cols, batch - c0);
  const int P = plane_stride(cols * m);
  const int PW = plane_stride(m - 1);
  uint32_t* v = smem;
  uint32_t* tws = smem + NW * P;

  // the tile: row p of the tile is ncol elements, contiguous in x
  const int row_chunks = ncol * Q4;
  for (int u = threadIdx.x; u < m * row_chunks; u += kThreads) {
    const int p = u / row_chunks;
    const int rem = u - p * row_chunks;
    const int col = rem / Q4;
    const int4 val = reinterpret_cast<const int4*>(x + ((long long)p * batch + c0) * L)[rem];
    chunk_to_planes(v, P, col * m + p, rem - col * Q4, val);
  }
  const int4* tsrc = reinterpret_cast<const int4*>(tw);
  for (int s = 0; s < log_m; ++s) {
    const int q = m >> (s + 1);
    const int off = m - (m >> s);
    for (int u = threadIdx.x; u < q * Q4; u += kThreads) {
      const int j = u / Q4;
      chunk_to_planes(tws, PW, off + j, u - j * Q4, tsrc[(s * (m >> 1) + j) * Q4 + u - j * Q4]);
    }
  }
  __syncthreads();

  // radix 4: stages s and s + 1 on {i0, i0 + Q, i0 + 2Q, i0 + 3Q}, Q = m >> (s + 2)
  int s = 0;
  for (; s + 1 < log_m; s += 2) {
    const int lq = log_m - s - 2;
    const int Q = 1 << lq;
    const int offa = m - (m >> s);
    const int offc = m - (m >> (s + 1));
    const int groups = ncol << (log_m - 2);
    for (int g = threadIdx.x; g < groups; g += kThreads) {
      const int col = g >> (log_m - 2);
      const int h = g & ((m >> 2) - 1);
      const int jp = h & (Q - 1);
      const int i0 = col * m + ((h >> lq) << (lq + 2)) + jp;
      const Fe<NW> x0 = ld_plane<NW>(v, P, i0);
      const Fe<NW> x1 = ld_plane<NW>(v, P, i0 + Q);
      const Fe<NW> x2 = ld_plane<NW>(v, P, i0 + 2 * Q);
      const Fe<NW> x3 = ld_plane<NW>(v, P, i0 + 3 * Q);
      const Fe<NW> t0 = fe_add<NW>(x0, x2, fc);
      const Fe<NW> t2 = fe_mul<NW>(fe_sub<NW>(x0, x2, fc), ld_plane<NW>(tws, PW, offa + jp), fc);
      const Fe<NW> t1 = fe_add<NW>(x1, x3, fc);
      const Fe<NW> t3 = fe_mul<NW>(fe_sub<NW>(x1, x3, fc), ld_plane<NW>(tws, PW, offa + jp + Q), fc);
      const Fe<NW> wc = ld_plane<NW>(tws, PW, offc + jp);
      st_plane<NW>(v, P, i0, fe_add<NW>(t0, t1, fc));
      st_plane<NW>(v, P, i0 + Q, fe_mul<NW>(fe_sub<NW>(t0, t1, fc), wc, fc));
      st_plane<NW>(v, P, i0 + 2 * Q, fe_add<NW>(t2, t3, fc));
      st_plane<NW>(v, P, i0 + 3 * Q, fe_mul<NW>(fe_sub<NW>(t2, t3, fc), wc, fc));
    }
    __syncthreads();
  }
  if (s < log_m) {  // odd R: the last stage, pairs (2h, 2h + 1), twiddle tw[s][0]
    const Fe<NW> w = ld_plane<NW>(tws, PW, m - 2);
    for (int g = threadIdx.x; g < ncol << (log_m - 1); g += kThreads) {
      const int col = g >> (log_m - 1);
      const int i0 = col * m + 2 * (g & ((m >> 1) - 1));
      const Fe<NW> a = ld_plane<NW>(v, P, i0);
      const Fe<NW> b = ld_plane<NW>(v, P, i0 + 1);
      st_plane<NW>(v, P, i0, fe_add<NW>(a, b, fc));
      st_plane<NW>(v, P, i0 + 1, fe_mul<NW>(fe_sub<NW>(a, b, fc), w, fc));
    }
    __syncthreads();
  }

  // natural row k of column col sits at col * m + rev(k)
  if (LEVEL) {  // times T[k, j1], in place
    const long long n1 = batch / B;
    for (int g = threadIdx.x; g < ncol * m; g += kThreads) {
      const int k = g / ncol;
      const int col = g - k * ncol;
      const int i = col * m + bit_rev(k, log_m);
      const Fe<NW> t = load_fe<NW>(lvl + ((long long)k * n1 + (c0 + col) / B) * L);
      st_plane<NW>(v, P, i, fe_mul<NW>(ld_plane<NW>(v, P, i), t, fc));
    }
    __syncthreads();
  }
  // Where B divides C (the first level, B = 1), the block's output is C / B
  // runs of m * B contiguous rows: walk them in order.  Else walk the tile
  // row by row, C (or B) rows contiguous.
  const bool runs = LEVEL && B < cols && cols % B == 0;
  const int Bi = (int)(runs ? B : 1);
  for (int u = threadIdx.x; u < m * row_chunks; u += kThreads) {
    int k, col, q;
    if (runs) {
      const int t = u / Q4;
      q = u - t * Q4;
      const int b = t % Bi;
      k = (t / Bi) & (m - 1);
      col = (t / (Bi * m)) * Bi + b;
    } else {
      k = u / row_chunks;
      const int rem = u - k * row_chunks;
      col = rem / Q4;
      q = rem - col * Q4;
    }
    long long row;
    if (LEVEL) {
      const long long c = c0 + col;
      const long long j1 = c / B;
      row = (j1 * m + k) * B + (c - j1 * B);
    } else {
      row = (long long)k * batch + c0 + col;
    }
    reinterpret_cast<int4*>(out + row * L)[q] = chunk_from_planes(v, P, col * m + bit_rev(k, log_m), q);
  }
}

template <int NW, int LEVEL>
int launch_leaf(const int32_t* x, const int32_t* tw, const int32_t* lvl, int32_t* out, int log_m,
                long long batch, long long B, const FieldConsts& fc, cudaStream_t st) {
  const size_t shmem = (size_t)leaf_words(NW, log_m) * 4;
  if (shmem > kMaxShared) return (int)cudaErrorInvalidValue;
  if (shmem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(ntt_leaf_kernel<NW, LEVEL>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)shmem);
    if (e != cudaSuccess) return (int)e;
  }
  const int cols = leaf_cols(log_m);
  const unsigned blocks = (unsigned)((batch + cols - 1) / cols);
  ntt_leaf_kernel<NW, LEVEL><<<blocks, kThreads, shmem, st>>>(x, tw, lvl, out, log_m, batch, B, fc);
  return (int)cudaGetLastError();
}

template <int NW>
int launch_leaf_any(const int32_t* x, const int32_t* tw, const int32_t* lvl, int32_t* out, int log_m,
                    long long batch, long long B, const FieldConsts& fc, cudaStream_t st) {
  return lvl ? launch_leaf<NW, 1>(x, tw, lvl, out, log_m, batch, B, fc, st)
             : launch_leaf<NW, 0>(x, tw, lvl, out, log_m, batch, B, fc, st);
}

}  // namespace

// 1 where one block holds a whole row of 2^log_n elements of nw words
// (pease_rows runs every stage in one launch), else 0.
extern "C" int tec_pease_rows_fit(int nw, int log_n) {
  if (log_n < 1 || log_n > 16) return 0;
  return (size_t)pease_rows_words(nw, log_n) * 4 <= (size_t)kMaxShared ? 1 : 0;
}

// y, out: (batch, 2^log_n, 2*nw) int32 half-limbs, 16-byte aligned; tw:
// (2^(log_n-1), 2*nw) master table w^j.  Stages s0 .. s1-1 of the Pease NTT
// over every row, the result bit-reversed along the row where bitrev is set;
// needs tec_pease_rows_fit.
extern "C" int tec_pease_rows(int nw, const void* y, const void* tw, void* out, long long batch,
                              int log_n, int s0, int s1, int bitrev, const uint32_t* fc,
                              void* stream) {
  if (batch <= 0) return 0;
  if (!tec_pease_rows_fit(nw, log_n) || s0 < 0 || s1 > log_n || s0 > s1)
    return (int)cudaErrorInvalidValue;
  FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 8)
    return launch_pease_rows<8>((const int32_t*)y, (const int32_t*)tw, (int32_t*)out, batch, log_n,
                                s0, s1, bitrev, c, st);
  if (nw == 12)
    return launch_pease_rows<12>((const int32_t*)y, (const int32_t*)tw, (int32_t*)out, batch, log_n,
                                 s0, s1, bitrev, c, st);
  return (int)cudaErrorInvalidValue;
}

// Stage s of the Pease NTT over every row, from device memory (rows of any
// length); out must not alias y.
extern "C" int tec_pease_stage(int nw, const void* y, const void* tw, void* out, long long batch,
                               int log_n, int s, int bitrev, const uint32_t* fc, void* stream) {
  if (batch <= 0 || log_n <= 0) return 0;
  const long long total = batch << (log_n - 1);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 8) {
    pease_stage_kernel<8><<<blocks, threads, 0, st>>>(
        (const int32_t*)y, (const int32_t*)tw, (int32_t*)out, total, log_n, s, bitrev, c);
  } else if (nw == 12) {
    pease_stage_kernel<12><<<blocks, threads, 0, st>>>(
        (const int32_t*)y, (const int32_t*)tw, (int32_t*)out, total, log_n, s, bitrev, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x: (2^log_m, batch, 2*nw) int32 half-limbs, 16-byte aligned; tw: (log_m,
// 2^(log_m-1), 2*nw).  The 2^log_m-point NTT of every column, natural
// order, 1 <= log_m <= 10.  lvl null: out is (2^log_m, batch, 2*nw).  Else
// lvl is the (2^log_m, batch / B, 2*nw) level table, B divides batch, and
// out the (batch / B, 2^log_m * B, 2*nw) twiddled, transposed rows.
extern "C" int tec_ntt_leaf(int nw, const void* x, const void* tw, const void* lvl, void* out,
                            int log_m, long long batch, long long B, const uint32_t* fc,
                            void* stream) {
  if (batch <= 0) return 0;
  if (log_m < 1 || log_m > 10 || (lvl && (B <= 0 || batch % B != 0)))
    return (int)cudaErrorInvalidValue;
  FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 8)
    return launch_leaf_any<8>((const int32_t*)x, (const int32_t*)tw, (const int32_t*)lvl,
                              (int32_t*)out, log_m, batch, B, c, st);
  if (nw == 12)
    return launch_leaf_any<12>((const int32_t*)x, (const int32_t*)tw, (const int32_t*)lvl,
                               (int32_t*)out, log_m, batch, B, c, st);
  return (int)cudaErrorInvalidValue;
}
