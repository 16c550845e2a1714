// K3's batched point ops on G1 (coordinates in Fq): point.cuh's formulas
// at ext 1.
#include "point.cuh"

// The arguments are point_args.cuh's, coordinates of 2 * nw half-limbs.
extern "C" int tec_point(int op, int nw, const void* const* in, const long long* in_stride, const void* keep,
                         void* const* out, long long out_stride, long long n, const uint32_t* fc, void* stream) {
  if (n <= 0) return 0;
  const PointArgs a = make_args(op, in, in_stride, keep, out, out_stride, n);
  const FieldConsts c = tec::field_consts_from_host(fc);
  cudaStream_t s = (cudaStream_t)stream;
  if (nw == 8) return launch<tec::Ext1<8>>(op, a, c, s);
  if (nw == 12) return launch<tec::Ext1<12>>(op, a, c, s);
  return (int)cudaErrorInvalidValue;
}
