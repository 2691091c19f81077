// mod_madd: out = (a * b + c) mod m, one lane per thread, for the
// secp256k1 base field p or group order n.
//
// Replaces: dkg_tpu/ops/pallas_field.py _mod_madd_tiles (the Pallas
// kernel behind mod_madd), which the JAX package runs as the Horner step
// of poly/device.py eval_many.  The port also folds the batch
// verifier's scalar RLC (dkg/ceremony.py _field_dot) through it.
//
// What bounds it on the H100: a lane reads 3 x 64 bytes and writes 64,
// and does 86 (p) or 134 (n) 32x32->64-bit multiply-adds: 64 for the
// schoolbook product, the rest for the fold reduction in field.cuh.
// Counted as two 32-bit multiplies each (low and high half) at the
// card's 16.7 T/s (132 SMs x 64 INT32 lanes x 1.98 GHz), 134
// multiply-adds take 16 ps a lane, while 256 bytes at 3.35 TB/s take
// 76 ps: memory is the bound, as long as the carry chains (each
// multiply-add also adds with carry) keep the integer work under it.  The design keeps the whole
// element in registers (8 words), loads and stores 16 bytes at a time,
// takes the reduction constants from __constant__ memory, and uses no
// shared memory.  The Horner loop at n = 1024 gives it 1M lanes per
// launch, which fills the card; the RLC fold gives it only n lanes per
// launch (one dealer at a time), which does not.
#include <cuda_runtime.h>

#include "field.cuh"
#include "lanes.cuh"

namespace {

using namespace dkg;

template <int F>
__global__ void __launch_bounds__(kThreads)
    mod_madd_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    const int32_t* __restrict__ c, int32_t* __restrict__ out, int64_t n) {
  DKG_LANES(lane, n) {
    uint32_t x[kWords], y[kWords], z[kWords], r[kWords];
    load16(a + lane * kLimbs, x);
    load16(b + lane * kLimbs, y);
    load16(c + lane * kLimbs, z);
    fmadd<F>(r, x, y, z);
    store16(out + lane * kLimbs, r);
  }
}

}  // namespace

extern "C" {

// field: 0 = secp256k1 base field, 1 = secp256k1 group order.
int dkg_mod_madd(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out, int64_t n,
                 int field, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (field == kBase) {
    mod_madd_kernel<kBase><<<blocks_for(n), kThreads, 0, s>>>(a, b, c, out, n);
  } else if (field == kScalar) {
    mod_madd_kernel<kScalar><<<blocks_for(n), kThreads, 0, s>>>(a, b, c, out, n);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
