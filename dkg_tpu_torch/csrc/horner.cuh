// The per-lane bodies of the two multi-step mod_madd kernels of
// field_kernels.cu, over field.cuh's fmadd: the Horner form
// (poly/device.py eval_many) and the dot form (dkg/ceremony.py
// _field_dot).  Shared with csrc/host_check.cpp, which runs them on the
// host at the field edge values.
#pragma once

#include "field.cuh"

namespace dkg {

// Coefficients a block stages in shared memory at a time (two buffers of
// kHornerChunk * L limbs: 16 KiB at L = 16, 24 KiB at 24).
constexpr int kHornerChunk = 128;

// acc <- acc x + c_l for l = count - 1 .. 0, the count stored coefficients
// at c (2N limbs apart).
template <int F>
__device__ __forceinline__ void horner_steps(uint32_t acc[], const uint32_t x[], const int32_t* c,
                                             int count) {
  constexpr int N = Field<F>::N;
#pragma unroll 1
  for (int l = count - 1; l >= 0; --l) {
    uint32_t cl[N];
    load_elem<N>(c + l * 2 * N, cl);
    fmadd<F>(acc, acc, x, cl);
  }
}

// acc <- acc + w_j v_jk over rows j = first, first + stride, ... < m:
// weights w (m, 2N limbs), values v (m, K, 2N), output lane k.
template <int F>
__device__ __forceinline__ void dot_steps(uint32_t acc[], const int32_t* w, const int32_t* v,
                                          int64_t m, int64_t K, int64_t k, int64_t first,
                                          int64_t stride) {
  constexpr int N = Field<F>::N;
#pragma unroll 1
  for (int64_t j = first; j < m; j += stride) {
    uint32_t a[N], b[N];
    load_elem<N>(w + j * 2 * N, a);
    load_elem<N>(v + (j * K + k) * 2 * N, b);
    fmadd<F>(acc, a, b, acc);
  }
}

}  // namespace dkg
