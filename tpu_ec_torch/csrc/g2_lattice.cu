// K3's chain entry on G2 (coordinates in Fq2, c0 then c1), the bucket lattice:
// chain.cuh's formulas at ext 2, a unit of its own so that it compiles beside
// the other G2 chain entries.
#include "chain.cuh"

// The arguments are chain.cuh's lattice_entry, coordinates of 4 * nw half-limbs.
extern "C" int tec_point_lattice_fp2(int nw, const void* x, long long x_stride, const void* y, long long y_stride,
                                     const void* digits, int m, long long groups, int windows, int nbuckets,
                                     void* table, void* const* sums, const uint32_t* fc, void* stream) {
  return lattice_entry<2>(nw, x, x_stride, y, y_stride, digits, m, groups, windows, nbuckets, table, sums, fc,
                          stream);
}
