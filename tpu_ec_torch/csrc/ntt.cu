// K4: block-resident leaf NTT (the fused NTT's leaves) and K5: one Pease
// stage (the staged NTT).
//
// K4 replaces tpu_ec/ops/pallas/ntt_fused.py:_leaf_call (and
// _leaf_call_list) together with the bit-reversal gather of _leaf_apply: a
// whole 2^R-point decimation-in-frequency NTT per column, natural order out.
// K5 replaces tpu_ec/ops/pallas/ntt.py:_butterfly_call together with the
// stage's twiddle broadcast and interleave: (a, b) -> (a + b, (a - b) * w^e)
// with e = (i >> s) << s, stored interleaved.  Every field op is canonical,
// so both are bit-identical to tpu_ec's stages.
//
// Bound on the H100: integer-ALU for both.  A butterfly is one 256-bit
// product (2*8*8 + 8 = 136 32x32->64 multiply-adds) against 96 bytes of
// traffic for K5 (a, b in; u, v out; the twiddle mostly cached), and R
// products per element pair for K4 against 64 bytes per element pair.
//
// Simple design.  K5: one thread per pair, the twiddle index computed from
// the master w^j table in the kernel (no gathered per-stage table).  K4: one
// thread block per leaf column (several columns per block for small leaves,
// so a block has at least 128 threads); the column's 2^R elements sit in
// shared memory (2^8 * 32 B = 8 KB at leaf 8 on Fr), m/2 threads do one
// butterfly each per stage with __syncthreads() between stages, and the
// block writes the result in natural order (index bit-reversed).  The
// column-strided loads of the (m, B) row layout are not coalesced; that is
// later work.
#include "field.cuh"

namespace {

using tec::Fe;
using tec::FieldConsts;

template <int NW>
__global__ void pease_stage_kernel(const int32_t* __restrict__ y, const int32_t* __restrict__ tw,
                                   int32_t* __restrict__ out, long long total, int log_n, int s,
                                   FieldConsts fc) {
  using namespace tec;
  constexpr int L = 2 * NW;
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const long long half = 1LL << (log_n - 1);
  const long long b = i >> (log_n - 1);
  const long long j = i & (half - 1);
  const int32_t* row = y + b * (2 * half) * L;
  Fe<NW> a = load_fe<NW>(row + j * L);
  Fe<NW> c = load_fe<NW>(row + (j + half) * L);
  Fe<NW> w = load_fe<NW>(tw + ((j >> s) << s) * L);
  int32_t* o = out + (b * (2 * half) + 2 * j) * L;
  store_fe<NW>(o, fe_add<NW>(a, c, fc));
  store_fe<NW>(o + L, fe_mul<NW>(fe_sub<NW>(a, c, fc), w, fc));
}

// x, out: (m, batch, L) rows; tw: (log_m, m/2, L) DIF stage twiddles, of
// which stage s reads the first m/2^(s+1) (W_m^(j 2^s) for pair j).
// blockDim = (m/2, cols); block k holds columns k*cols .. k*cols + cols - 1.
template <int NW>
__global__ void ntt_leaf_kernel(const int32_t* __restrict__ x, const int32_t* __restrict__ tw,
                                int32_t* __restrict__ out, int log_m, long long batch,
                                FieldConsts fc) {
  using namespace tec;
  constexpr int L = 2 * NW;
  extern __shared__ uint32_t smem[];
  const int m = 1 << log_m;
  const int h = m >> 1;
  const int p = threadIdx.x;
  const long long col = (long long)blockIdx.x * blockDim.y + threadIdx.y;
  const bool active = col < batch;
  Fe<NW>* v = reinterpret_cast<Fe<NW>*>(smem) + threadIdx.y * m;
  if (active) {
    v[p] = load_fe<NW>(x + ((long long)p * batch + col) * L);
    v[p + h] = load_fe<NW>(x + ((long long)(p + h) * batch + col) * L);
  }
  __syncthreads();
  for (int s = 0; s < log_m; ++s) {
    const int q = h >> s;  // half-block of stage s
    const int j = p % q;   // pair j of block p / q; its twiddle is block-independent
    const int i0 = (p / q) * 2 * q + j;
    Fe<NW> a = v[i0];
    Fe<NW> b = v[i0 + q];
    Fe<NW> w = load_fe<NW>(tw + ((long long)s * h + j) * L);
    v[i0] = fe_add<NW>(a, b, fc);
    v[i0 + q] = fe_mul<NW>(fe_sub<NW>(a, b, fc), w, fc);
    __syncthreads();
  }
  if (active) {
    const int shift = 32 - log_m;
    for (int i = p; i < m; i += h) {
      const int k = (int)(__brev((unsigned)i) >> shift);
      store_fe<NW>(out + ((long long)k * batch + col) * L, v[i]);
    }
  }
}

template <int NW>
int launch_leaf(const int32_t* x, const int32_t* tw, int32_t* out, int log_m, long long batch,
                const FieldConsts& fc, cudaStream_t st) {
  const int h = 1 << (log_m - 1);
  const int cols = h >= 128 ? 1 : 128 / h;
  const dim3 block(h, cols);
  const unsigned blocks = (unsigned)((batch + cols - 1) / cols);
  const size_t shmem = (size_t)cols * (2 * h) * sizeof(Fe<NW>);
  ntt_leaf_kernel<NW><<<blocks, block, shmem, st>>>(x, tw, out, log_m, batch, fc);
  return (int)cudaGetLastError();
}

}  // namespace

// y, out: (batch, 2^log_n, 2*nw) int32 half-limbs; tw: (2^(log_n-1), 2*nw)
// master table w^j.  Stage s of the Pease NTT over every row of the batch.
extern "C" int tec_pease_stage(int nw, const void* y, const void* tw, void* out, long long batch,
                               int log_n, int s, const uint32_t* fc, void* stream) {
  if (batch <= 0 || log_n <= 0) return 0;
  const long long total = batch << (log_n - 1);
  const int threads = 256;
  const unsigned blocks = (unsigned)((total + threads - 1) / threads);
  FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 8) {
    pease_stage_kernel<8><<<blocks, threads, 0, st>>>(
        (const int32_t*)y, (const int32_t*)tw, (int32_t*)out, total, log_n, s, c);
  } else if (nw == 12) {
    pease_stage_kernel<12><<<blocks, threads, 0, st>>>(
        (const int32_t*)y, (const int32_t*)tw, (int32_t*)out, total, log_n, s, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

// x, out: (2^log_m, batch, 2*nw) int32 half-limbs; tw: (log_m, 2^(log_m-1),
// 2*nw).  The 2^log_m-point NTT of every column, natural order out;
// 1 <= log_m <= 10.
extern "C" int tec_ntt_leaf(int nw, const void* x, const void* tw, void* out, int log_m,
                            long long batch, const uint32_t* fc, void* stream) {
  if (batch <= 0) return 0;
  if (log_m < 1 || log_m > 10) return (int)cudaErrorInvalidValue;
  FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t st = (cudaStream_t)stream;
  if (nw == 8)
    return launch_leaf<8>((const int32_t*)x, (const int32_t*)tw, (int32_t*)out, log_m, batch, c, st);
  if (nw == 12)
    return launch_leaf<12>((const int32_t*)x, (const int32_t*)tw, (int32_t*)out, log_m, batch, c, st);
  return (int)cudaErrorInvalidValue;
}
