// pt_double: 2^n_doubles * P in one launch, one point per thread, on
// secp256k1 (projective, RCB15 algorithm 9, point.cuh) or edwards25519
// (extended, dbl-2008-hwcd, edwards.cuh).
//
// Replaces: dkg_tpu/ops/pallas_point.py _double_call (the Pallas kernel
// behind pt_double) for both curve kinds at 16 limbs.  No ceremony path
// launches it: every window step, Edwards included, is one
// pt_window_step launch (groups/device.py window_step), so it serves
// groups/device.double, which the point RLC's "bits" schedule calls.
//
// What bounds it on the H100: a lane reads one point and writes one (384
// bytes on secp256k1, 512 on edwards25519) and does n_doubles x 700 or
// n_doubles x 584 32x32->64-bit multiply-adds.  At n_doubles = 4 that is
// 335 or 280 ps of multiplies (two 32-bit multiplies each at 16.7 T/s) to
// 115 or 153 ps of bytes a lane: bound by the multiplier.  The design
// keeps the point in registers across all n_doubles doublings (as the
// Pallas kernel keeps it in VMEM), one lane per thread, no shared memory.
// The Straus window step's shape is t + 1 = 86 lanes at ristretto255
// n = 256: one block of the card's 132 SMs, a latency figure.
//
// Each curve has its own C entry: dkg_pt_double runs point_kernels.cuh's
// doubling kernel instantiated for secp256k1, dkg_ed_pt_double the
// Edwards one below.
#include <cuda_runtime.h>

#include "edwards.cuh"
#include "lanes.cuh"
#include "point_kernels.cuh"

namespace {

using namespace dkg;

constexpr int kEdPointWords = kEdCoords * kEdLimbs;  // 64

__global__ void __launch_bounds__(kThreads)
    ed_pt_double_kernel(const int32_t* __restrict__ p, int32_t* __restrict__ out, int64_t n,
                        int n_doubles) {
  DKG_LANES(lane, n) {
    ed_double_lane(p + lane * kEdPointWords, n_doubles, out + lane * kEdPointWords);
  }
}

}  // namespace

extern "C" {

int dkg_pt_double(const int32_t* p, int32_t* out, int64_t n, int n_doubles, void* stream) {
  return dkg::launch_pt_double<dkg::Secp256k1>(p, out, n, n_doubles, stream);
}

int dkg_ed_pt_double(const int32_t* p, int32_t* out, int64_t n, int n_doubles, void* stream) {
  if (n <= 0) return 0;
  if (n_doubles < 0) return (int)cudaErrorInvalidValue;
  ed_pt_double_kernel<<<dkg::blocks_for(n), dkg::kThreads, 0, (cudaStream_t)stream>>>(
      p, out, n, n_doubles);
  return (int)cudaGetLastError();
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
