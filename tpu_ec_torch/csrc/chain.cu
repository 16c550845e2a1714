// K3's chain entries on G1 (coordinates in Fq): chain.cuh's formulas at
// ext 1, and the product-latency yardstick of their serial bound.
#include "chain.cuh"

namespace {

// The serial bound's yardstick, on no path: one thread runs `steps` field
// products in series, x = x y (field.cuh's one-thread product, lazy, as
// each lane of a tile computes it), and stores x canonical.
template <int NW>
__global__ void mul_chain_kernel(const int32_t* a, const int32_t* b, int steps, int32_t* out,
                                 const __grid_constant__ FieldConsts fc) {
  Fe<NW> x = tec::load_fe<NW>(a);
  const Fe<NW> y = tec::load_fe<NW>(b);
#pragma unroll 1
  for (int s = 0; s < steps; ++s) x = tec::mul_eo<NW>(x, y, fc);
  tec::store_fe<NW>(out, tec::fe_canon<NW>(x, fc));
}

}  // namespace

// The entries' arguments are chain.cuh's horner_entry, scalar_mul_entry,
// stage_entry and lattice_entry, coordinates of 2 * nw half-limbs.
extern "C" int tec_point_horner(int nw, const void* const* in, const long long* in_stride, int windows,
                                long long chunks, int w, void* const* out, const uint32_t* fc, void* stream) {
  return horner_entry<1>(nw, in, in_stride, windows, chunks, w, out, fc, stream);
}

extern "C" int tec_point_scalar_mul(int nw, const void* const* in, const long long* in_stride, const void* k,
                                    long long k_stride, void* const* out, long long n, const uint32_t* fc,
                                    void* stream) {
  return scalar_mul_entry<1>(nw, in, in_stride, k, k_stride, out, n, fc, stream);
}

extern "C" int tec_ec_fft_stage(int nw, const void* const* in, long long in_stride, void* const* out, const void* tw,
                                long long batches, int log_n, int stage, const uint32_t* fc, void* stream) {
  return stage_entry<1>(nw, in, in_stride, out, tw, batches, log_n, stage, fc, stream);
}

extern "C" int tec_point_lattice(int nw, const void* x, long long x_stride, const void* y, long long y_stride,
                                 const void* digits, int m, long long groups, int windows, int nbuckets, void* table,
                                 void* const* sums, const uint32_t* fc, void* stream) {
  return lattice_entry<1>(nw, x, x_stride, y, y_stride, digits, m, groups, windows, nbuckets, table, sums, fc,
                          stream);
}

// The lanes of a chain in chain.cuh's chain kernels at nw words and
// ext (1: Fq, G1; 2: Fq2, G2).
extern "C" int tec_chain_tile(int nw, int ext) {
  if (nw != 8 && nw != 12) return 0;
  return ext == 1 ? kTile : ext == 2 ? kTile2 : 0;
}

// out = a b^steps R^-steps, canonical, by `steps` products in series on one
// thread: a, b, out one (2*nw) int32 element each.  Times one product's
// latency (the serial bound of the chains above).
extern "C" int tec_mul_chain(int nw, const void* a, const void* b, int steps, void* out, const uint32_t* fc,
                             void* stream) {
  if (steps < 0) return (int)cudaErrorInvalidValue;
  const FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) {
    mul_chain_kernel<8><<<1, 1, 0, s>>>((const int32_t*)a, (const int32_t*)b, steps, (int32_t*)out, c);
  } else if (nw == 12) {
    mul_chain_kernel<12><<<1, 1, 0, s>>>((const int32_t*)a, (const int32_t*)b, steps, (int32_t*)out, c);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
