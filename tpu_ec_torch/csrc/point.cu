// K3's batched point ops on G1 (coordinates in Fq): point.cuh's formulas
// at ext 1.
#include "point.cuh"

// point_entry's arguments (point.cuh), coordinates of 2 * nw half-limbs.
extern "C" int tec_point(int op, int nw, const void* const* in, const long long* in_stride, const void* keep,
                         void* const* out, long long out_stride, long long n, const uint32_t* fc, void* stream) {
  return point_entry<1>(op, nw, in, in_stride, keep, out, out_stride, n, fc, stream);
}
