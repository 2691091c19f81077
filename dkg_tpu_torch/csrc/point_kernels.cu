// Complete projective point kernels on secp256k1, one point per thread:
// pt_add, pt_madd, pt_window_step and pt_ladder_mul_add.
//
// Replaces: dkg_tpu/ops/pallas_point.py _add_call, _madd_call,
// _window_call and _ladder_call (the Pallas kernels behind pt_add,
// pt_madd, pt_window_step and pt_ladder_mul_add), Weierstrass a = 0 at
// 16 limbs.  Outputs equal the JAX package's limb for limb: the same
// RCB15 formulas (point.cuh) over exact, canonical field ops.
//
// What bounds them on the H100: a point is 192 bytes in memory (3 x 16
// int32 limbs).  Per lane, in 32x32->64-bit multiply-adds (point.cuh):
// pt_add 1056 for 576 bytes moved, pt_madd 970 for 576, pt_window_step
// 4 x 700 + 1056 = 3856 for 576.  pt_ladder_mul_add's x is public, so
// x * P + A needs only (bit_length(x) - 1) x 700 + popcount(x) x 1056
// for 580 bytes: 10889 on average over the ceremony's x = 1..1024.
// Counted as two 32-bit multiplies each at 16.7 T/s against 3.35 TB/s,
// pt_add and pt_madd sit near the balance point (126 and 116 ps of
// multiplies to 172 ps of bytes a lane) and the window step (462 ps) and
// the ladder (1.3 ns) are bound by the multiplier.  This ladder runs a
// fixed nbits doublings and adds a lane, nbits x (700 + 1056) + 1056 =
// 20372 at nbits = 11, about 1.9 times what those x need; skipping the
// leading zero bits and the adds of zero bits is left to a later change.
//
// The design keeps every coordinate and temporary in registers across
// the whole sequence (the window step's four doublings and the ladder's
// nbits double-and-adds never touch memory between steps, as the Pallas
// kernels keep them in VMEM), reads constants from __constant__ memory,
// and uses no shared memory.  The cost of that is register pressure: an
// add holds about a dozen 8-word temporaries and the ladder also carries
// P and the accumulator.  ptxas (nvcc 12.9, sm_90a, as chip_smoke.py
// prints it) gives pt_add and pt_madd 142 registers, pt_window_step 128
// with 32 bytes spilled, and the ladder 254 with none: from four
// (window step) down to two (ladder) 128-thread blocks fit on an SM.
// Trimming the live set is left to a later change.
//
// The ladder is launched once per Horner step of eval_point_poly, over
// n = 1024 lanes at the ceremony's shape: 8 blocks of 128 threads on a
// 132-SM card, so one launch leaves most of the card idle.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "point.cuh"

namespace {

using namespace dkg;

constexpr int kPointWords = kCoords * kLimbs;  // int32 words per stored point

__global__ void __launch_bounds__(kThreads)
    pt_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                  int32_t* __restrict__ out, int64_t n) {
  DKG_LANES(lane, n) {
    add_lane(p + lane * kPointWords, q + lane * kPointWords, out + lane * kPointWords);
  }
}

__global__ void __launch_bounds__(kThreads)
    pt_madd_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                   int32_t* __restrict__ out, int64_t n) {
  DKG_LANES(lane, n) {
    madd_lane(p + lane * kPointWords, q + lane * kPointWords, out + lane * kPointWords);
  }
}

__global__ void __launch_bounds__(kThreads)
    pt_window_step_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ entry,
                          int32_t* __restrict__ out, int64_t n, int n_doubles) {
  DKG_LANES(lane, n) {
    window_step_lane(acc + lane * kPointWords, entry + lane * kPointWords, n_doubles,
                     out + lane * kPointWords);
  }
}

__global__ void __launch_bounds__(kThreads)
    pt_ladder_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ addend,
                     const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t n,
                     int nbits) {
  DKG_LANES(lane, n) {
    ladder_lane(p + lane * kPointWords, addend + lane * kPointWords, (uint32_t)x[lane], nbits,
                out + lane * kPointWords);
  }
}

}  // namespace

extern "C" {

int dkg_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  pt_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

int dkg_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  pt_madd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

int dkg_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                       int n_doubles, void* stream) {
  if (n <= 0) return 0;
  if (n_doubles < 0) return (int)cudaErrorInvalidValue;
  pt_window_step_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(acc, entry, out, n,
                                                                              n_doubles);
  return (int)cudaGetLastError();
}

int dkg_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                          int32_t* out, int64_t n, int nbits, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > 31) return (int)cudaErrorInvalidValue;
  pt_ladder_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, addend, x, out, n,
                                                                         nbits);
  return (int)cudaGetLastError();
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
