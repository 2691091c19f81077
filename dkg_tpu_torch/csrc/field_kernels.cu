// mod_madd: out = (a * b + c) mod m, and mod_mul: out = (a * b) mod m,
// one lane per thread, over the secp256k1 base field p or group order n,
// the ed25519 base field 2^255 - 19, the ristretto255 scalar field l, or
// BLS12-381's base field p (24 limbs) and scalar field r.
//
// Replaces: dkg_tpu/ops/pallas_field.py _mod_madd_tiles (the Pallas
// kernel behind mod_madd), which the JAX package runs as the Horner step
// of poly/device.py eval_many.  The port also folds the batch
// verifier's scalar RLC (dkg/ceremony.py _field_dot) through it.  And
// _mod_mul_tiles (behind the standalone mod_mul): the port runs it as
// every multiply of the transcript digest's canonical affine form
// (groups/device.py affine_canon: the batch inversion's chain over 256
// rows of 1368 lanes at n = 1024, then x / Z and y / Z over all 350,208
// commitments).  mod_mul is mod_madd without the addend: two elements
// read and one written, the same multiply-adds, so the same reasoning
// below bounds it by the bytes.
//
// What bounds it on the H100: a lane reads three elements and writes one
// (3 x 64 + 64 bytes at 16 limbs, 3 x 96 + 96 for BLS12-381 p), and does
// 86 (secp256k1 p), 134 (n), 73 (ed25519 p), 189 (ristretto255 l,
// BLS12-381 r) or 403 (BLS12-381 p) 32x32->64-bit multiply-adds: N^2 for
// the schoolbook product, the rest for the reduction in field.cuh
// (folds, or Barrett for l, r and BLS12-381 p).  Counted as two 32-bit
// multiplies each (low and high half) at the card's 16.7 T/s (132 SMs x
// 64 INT32 lanes x 1.98 GHz), 189 multiply-adds take 23 ps a lane, while
// 256 bytes at 3.35 TB/s take 76 ps (BLS12-381 p: 48 ps to 115 ps):
// memory is the bound, as long as the carry chains (each multiply-add
// also adds with carry) keep the integer work under it.  The design
// keeps the whole element in registers (8 or 12 words), loads and stores
// 16 bytes at a time, takes the reduction constants from __constant__
// memory, and uses no shared memory.  The Horner loop at n = 1024 gives
// it 1M lanes per launch, which fills the card (n = 256 on ristretto255:
// 64k lanes); the RLC fold gives it only n lanes per launch (one dealer
// at a time), which does not.
#include <cuda_runtime.h>

#include "field.cuh"
#include "lanes.cuh"

namespace {

using namespace dkg;

template <int F>
__global__ void __launch_bounds__(kThreads)
    mod_madd_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                    const int32_t* __restrict__ c, int32_t* __restrict__ out, int64_t n) {
  constexpr int N = Field<F>::N;
  constexpr int L = 2 * N;  // stored limbs
  DKG_LANES(lane, n) {
    uint32_t x[N], y[N], z[N], r[N];
    load_elem<N>(a + lane * L, x);
    load_elem<N>(b + lane * L, y);
    load_elem<N>(c + lane * L, z);
    fmadd<F>(r, x, y, z);
    store_elem<N>(out + lane * L, r);
  }
}

template <int F>
__global__ void __launch_bounds__(kThreads)
    mod_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                   int32_t* __restrict__ out, int64_t n) {
  constexpr int N = Field<F>::N;
  constexpr int L = 2 * N;
  DKG_LANES(lane, n) {
    uint32_t x[N], y[N], r[N];
    load_elem<N>(a + lane * L, x);
    load_elem<N>(b + lane * L, y);
    fmul<F>(r, x, y);
    store_elem<N>(out + lane * L, r);
  }
}

template <int F>
int launch(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out, int64_t n,
           cudaStream_t s) {
  mod_madd_kernel<F><<<blocks_for(n), kThreads, 0, s>>>(a, b, c, out, n);
  return (int)cudaGetLastError();
}

template <int F>
int launch_mul(const int32_t* a, const int32_t* b, int32_t* out, int64_t n, cudaStream_t s) {
  mod_mul_kernel<F><<<blocks_for(n), kThreads, 0, s>>>(a, b, out, n);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// field: the ids of field.cuh (0 = secp256k1 p, 1 = secp256k1 n,
// 2 = ed25519 p, 3 = ristretto255 l, 4 = BLS12-381 p, 5 = BLS12-381 r).
int dkg_mod_madd(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out, int64_t n,
                 int field, void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case kSecpP: return launch<kSecpP>(a, b, c, out, n, s);
    case kSecpN: return launch<kSecpN>(a, b, c, out, n, s);
    case kEdP: return launch<kEdP>(a, b, c, out, n, s);
    case kEdL: return launch<kEdL>(a, b, c, out, n, s);
    case kBlsP: return launch<kBlsP>(a, b, c, out, n, s);
    case kBlsR: return launch<kBlsR>(a, b, c, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// field: as dkg_mod_madd's.
int dkg_mod_mul(const int32_t* a, const int32_t* b, int32_t* out, int64_t n, int field,
                void* stream) {
  if (n <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case kSecpP: return launch_mul<kSecpP>(a, b, out, n, s);
    case kSecpN: return launch_mul<kSecpN>(a, b, out, n, s);
    case kEdP: return launch_mul<kEdP>(a, b, out, n, s);
    case kEdL: return launch_mul<kEdL>(a, b, out, n, s);
    case kBlsP: return launch_mul<kBlsP>(a, b, out, n, s);
    case kBlsR: return launch_mul<kBlsR>(a, b, out, n, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
