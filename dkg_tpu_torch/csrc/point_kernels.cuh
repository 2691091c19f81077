// The short Weierstrass point kernels, templated on the curve C of
// point.cuh: one __global__ per lane body (pt_add, pt_madd, pt_double,
// pt_window_step, pt_ladder_mul_add), one point per thread, and its
// launcher.  point_kernels.cu and double_kernels.cu instantiate them for
// secp256k1 and bls_kernels.cu for BLS12-381 G1, each under C entries of
// its own.  For the card only.
//
// Every launcher takes the stored (n, 3, 2N) int32 points contiguous and
// already broadcast to the launch's n lanes, and returns
// cudaGetLastError(), or cudaErrorInvalidValue for a count the kernel
// does not take.
#pragma once

#include <cuda_runtime.h>

#include "lanes.cuh"
#include "point.cuh"

namespace dkg {

template <class C>
__global__ void __launch_bounds__(kThreads)
    pt_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                  int32_t* __restrict__ out, int64_t n) {
  constexpr int W = point_words<C>();
  DKG_LANES(lane, n) { add_lane<C>(p + lane * W, q + lane * W, out + lane * W); }
}

template <class C>
__global__ void __launch_bounds__(kThreads)
    pt_madd_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                   int32_t* __restrict__ out, int64_t n) {
  constexpr int W = point_words<C>();
  DKG_LANES(lane, n) { madd_lane<C>(p + lane * W, q + lane * W, out + lane * W); }
}

template <class C>
__global__ void __launch_bounds__(kThreads)
    pt_double_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ out, int64_t n,
                     int n_doubles) {
  constexpr int W = point_words<C>();
  DKG_LANES(lane, n) { double_lane<C>(p + lane * W, n_doubles, out + lane * W); }
}

template <class C>
__global__ void __launch_bounds__(kThreads)
    pt_window_step_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ entry,
                          int32_t* __restrict__ out, int64_t n, int n_doubles) {
  constexpr int W = point_words<C>();
  DKG_LANES(lane, n) {
    window_step_lane<C>(acc + lane * W, entry + lane * W, n_doubles, out + lane * W);
  }
}

template <class C>
__global__ void __launch_bounds__(kThreads)
    pt_ladder_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ addend,
                     const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t n,
                     int nbits) {
  constexpr int W = point_words<C>();
  DKG_LANES(lane, n) {
    ladder_lane<C>(p + lane * W, addend + lane * W, (uint32_t)x[lane], nbits, out + lane * W);
  }
}

template <class C>
inline int launch_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n,
                         void* stream) {
  if (n <= 0) return 0;
  pt_add_kernel<C><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

template <class C>
inline int launch_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n,
                          void* stream) {
  if (n <= 0) return 0;
  pt_madd_kernel<C><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

template <class C>
inline int launch_pt_double(const int32_t* p, int32_t* out, int64_t n, int n_doubles,
                            void* stream) {
  if (n <= 0) return 0;
  if (n_doubles < 0) return (int)cudaErrorInvalidValue;
  pt_double_kernel<C><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, out, n,
                                                                            n_doubles);
  return (int)cudaGetLastError();
}

template <class C>
inline int launch_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out,
                                 int64_t n, int n_doubles, void* stream) {
  if (n <= 0) return 0;
  if (n_doubles < 0) return (int)cudaErrorInvalidValue;
  pt_window_step_kernel<C><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(
      acc, entry, out, n, n_doubles);
  return (int)cudaGetLastError();
}

template <class C>
inline int launch_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                                    int32_t* out, int64_t n, int nbits, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > 31) return (int)cudaErrorInvalidValue;
  pt_ladder_kernel<C><<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, addend, x, out,
                                                                            n, nbits);
  return (int)cudaGetLastError();
}

}  // namespace dkg
