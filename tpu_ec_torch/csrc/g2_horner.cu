// K3's chain entry on G2 (coordinates in Fq2, c0 then c1), the Horner window combine:
// chain.cuh's formulas at ext 2, a unit of its own so that it compiles beside
// the other G2 chain entries.
#include "chain.cuh"

// The arguments are chain.cuh's, coordinates of 4 * nw half-limbs.
extern "C" int tec_point_horner_fp2(int nw, const void* const* in, const long long* in_stride, int windows,
                                    long long chunks, int w, void* const* out, const uint32_t* fc, void* stream) {
  return horner_entry<2>(nw, in, in_stride, windows, chunks, w, out, fc, stream);
}
