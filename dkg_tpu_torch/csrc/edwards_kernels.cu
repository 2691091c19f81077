// Extended twisted Edwards point kernels on edwards25519 (ristretto255),
// one point per thread: pt_add, pt_madd, pt_window_step and
// pt_ladder_mul_add.
//
// Replaces: dkg_tpu/ops/pallas_point.py _add_call, _madd_call,
// _window_call and _ladder_call (the Pallas kernels behind pt_add,
// pt_madd, pt_window_step and pt_ladder_mul_add) for cs.kind == "edwards"
// at 16 limbs.  Outputs equal the JAX package's limb for limb: the same
// HWCD formulas (edwards.cuh) over exact, canonical field ops.  The
// Edwards doubling kernel is in double_kernels.cu.
//
// What bounds them on the H100: a point is 256 bytes in memory (4 x 16
// int32 limbs).  Per lane, in 32x32->64-bit multiply-adds (edwards.cuh):
// pt_add 657 for 768 bytes moved, pt_madd 584 for 768.  At the card's
// 16.7 T 32-bit multiplies a second (two per multiply-add) against
// 3.35 TB/s that is 79 and 70 ps of multiplies to 229 ps of bytes a lane:
// both are bound by memory.  pt_ladder_mul_add's x is public, so x * P + A
// needs only (bit_length(x) - 1) x 584 + popcount(x) x 657 for 772 bytes:
// 6157 on average over the ceremony's x = 1..256, bound by the
// multiplier.  The kernel runs a fixed nbits doublings and adds a lane,
// nbits x (584 + 657) + 657 = 11826 at nbits = 9; the ceremony runs
// pt_ladder_horner (ladder_kernels.cu) in its place, which skips the adds
// of zero bits (hwcd doubling does not fix the identity, so the leading
// doublings stay).  pt_window_step is
// n_doubles x 584 + 657 for 768 bytes: 2993 at n_doubles = 4 (the KEM's
// scalar_mul and the Straus RLC), 5329 at 8 (the Pippenger combine), 361
// and 643 ps of multiplies to 229 ps of bytes a lane: bound by the
// multiplier.  It keeps the accumulator in registers across the doublings
// and the add, where the split route (pt_double, then pt_add) writes it
// out and reads it back between two launches.
//
// The design is point_kernels.cu's: every coordinate and temporary in
// registers for the whole sequence, constants (the modulus, 2d) from
// __constant__ memory, no shared memory, 128 threads a block.  Registers
// are the trouble: the ladder carries P, the accumulator and the sum, 96
// words before the add's temporaries; ptxas's count is printed by
// chip_smoke.py and written down in PERF.md.
#include <cuda_runtime.h>

#include "edwards.cuh"
#include "lanes.cuh"

namespace {

using namespace dkg;

constexpr int kPointWords = kEdCoords * kEdLimbs;  // int32 words per stored point

__global__ void __launch_bounds__(kThreads)
    ed_pt_add_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                     int32_t* __restrict__ out, int64_t n) {
  DKG_LANES(lane, n) {
    ed_add_lane(p + lane * kPointWords, q + lane * kPointWords, out + lane * kPointWords);
  }
}

__global__ void __launch_bounds__(kThreads)
    ed_pt_madd_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ q,
                      int32_t* __restrict__ out, int64_t n) {
  DKG_LANES(lane, n) {
    ed_madd_lane(p + lane * kPointWords, q + lane * kPointWords, out + lane * kPointWords);
  }
}

__global__ void __launch_bounds__(kThreads)
    ed_pt_window_step_kernel(const int32_t* __restrict__ acc, const int32_t* __restrict__ entry,
                             int32_t* __restrict__ out, int64_t n, int n_doubles) {
  DKG_LANES(lane, n) {
    ed_window_step_lane(acc + lane * kPointWords, entry + lane * kPointWords, n_doubles,
                        out + lane * kPointWords);
  }
}

__global__ void __launch_bounds__(kThreads)
    ed_pt_ladder_kernel(const int32_t* __restrict__ p, const int32_t* __restrict__ addend,
                        const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t n,
                        int nbits) {
  DKG_LANES(lane, n) {
    ed_ladder_lane(p + lane * kPointWords, addend + lane * kPointWords, (uint32_t)x[lane], nbits,
                   out + lane * kPointWords);
  }
}

}  // namespace

extern "C" {

int dkg_ed_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  ed_pt_add_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

int dkg_ed_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n, void* stream) {
  if (n <= 0) return 0;
  ed_pt_madd_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, q, out, n);
  return (int)cudaGetLastError();
}

int dkg_ed_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                          int n_doubles, void* stream) {
  if (n <= 0) return 0;
  if (n_doubles < 0) return (int)cudaErrorInvalidValue;
  ed_pt_window_step_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(acc, entry, out,
                                                                                 n, n_doubles);
  return (int)cudaGetLastError();
}

int dkg_ed_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                             int32_t* out, int64_t n, int nbits, void* stream) {
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > 31) return (int)cudaErrorInvalidValue;
  ed_pt_ladder_kernel<<<blocks_for(n), kThreads, 0, (cudaStream_t)stream>>>(p, addend, x, out,
                                                                            n, nbits);
  return (int)cudaGetLastError();
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
