// K3's chain entry on G2 (coordinates in Fq2, c0 then c1), the scalar multiplication:
// chain.cuh's formulas at ext 2, a unit of its own so that it compiles beside
// the other G2 chain entries.
#include "chain.cuh"

// The arguments are chain.cuh's, coordinates of 4 * nw half-limbs.
extern "C" int tec_point_scalar_mul_fp2(int nw, const void* const* in, const long long* in_stride, const void* k,
                                        long long k_stride, void* const* out, long long n, const uint32_t* fc,
                                        void* stream) {
  return scalar_mul_entry<2>(nw, in, in_stride, k, k_stride, out, n, fc, stream);
}
