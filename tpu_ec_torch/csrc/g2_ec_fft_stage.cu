// K3's chain entry on G2 (coordinates in Fq2, c0 then c1), one EC-FFT stage:
// chain.cuh's formulas at ext 2, a unit of its own so that it compiles beside
// the other G2 chain entries.
#include "chain.cuh"

// The arguments are chain.cuh's, coordinates of 4 * nw half-limbs.
extern "C" int tec_ec_fft_stage_fp2(int nw, const void* const* in, long long in_stride, void* const* out,
                                    const void* tw, long long batches, int log_n, int stage, const uint32_t* fc,
                                    void* stream) {
  return stage_entry<2>(nw, in, in_stride, out, tw, batches, log_n, stage, fc, stream);
}
