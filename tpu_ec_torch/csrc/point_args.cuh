// The arguments of K3's batched point kernels, G1 (point.cuh) and G2
// (g2_point.cu): the entries tec_point and tec_point_fp2 take op 0 add (6
// inputs), 1 add_mixed (5; in[2] null: P affine), 2 double (3); nw, the
// 32-bit words of Fq (8 or 12); in / out, arrays of device pointers to (n,
// 2 * nw * ext) int32 half-limb coordinates with the given row strides (in
// int32 elements; the outputs must not overlap the inputs); keep, null or
// n bytes (add, add_mixed: nonzero -> out = P).  They return the launch's
// CUDA error.
#pragma once

#include <cstdint>

namespace {

constexpr int kAdd = 0, kAddMixed = 1, kDouble = 2;
constexpr int kThreads = 128;

struct PointArgs {
  const int32_t* in[6];  // X1 Y1 Z1 X2 Y2 Z2 (add_mixed: X1 Y1 Z1 X2 Y2; Z1 null: P affine)
  long long in_stride[6];
  const uint8_t* keep;   // per row: copy P instead of adding; null: add every row
  int32_t* out[3];
  long long out_stride;
  long long n;
};

PointArgs make_args(int op, const void* const* in, const long long* in_stride, const void* keep,
                    void* const* out, long long out_stride, long long n) {
  const int n_in = op == kDouble ? 3 : (op == kAddMixed ? 5 : 6);
  PointArgs a;
  for (int k = 0; k < 6; ++k) {
    a.in[k] = k < n_in ? (const int32_t*)in[k] : nullptr;
    a.in_stride[k] = k < n_in ? in_stride[k] : 0;
  }
  a.keep = (const uint8_t*)keep;
  for (int k = 0; k < 3; ++k) a.out[k] = (int32_t*)out[k];
  a.out_stride = out_stride;
  a.n = n;
  return a;
}

}  // namespace
