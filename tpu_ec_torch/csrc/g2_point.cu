// K3's batched point ops on G2 (coordinates in Fq2, c0 then c1): point.cuh's
// formulas at ext 2.
#include "point.cuh"

// point_entry's arguments (point.cuh), coordinates of 4 * nw half-limbs.
extern "C" int tec_point_fp2(int op, int nw, const void* const* in, const long long* in_stride,
                             const void* keep, void* const* out, long long out_stride, long long n,
                             const uint32_t* fc, void* stream) {
  return point_entry<2>(op, nw, in, in_stride, keep, out, out_stride, n, fc, stream);
}
