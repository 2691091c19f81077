// mod_batch_inv: fields/device.py batch_inv (a Montgomery-trick inversion
// down axis 0 of x (rows, cols, L)) in one launch, one thread a column
// (csrc/inv.cuh batch_inv_column), over the three base fields whose
// points groups/device.py affine_canon makes affine: secp256k1 p, ed25519
// p and BLS12-381 p.
//
// Replaces dkg_tpu/ops/pallas_field.py _mod_mul_tiles (the Pallas kernel
// behind mod_mul) composed over the chain of dkg_tpu/fields/device.py
// batch_inv: its forward prefix products, inv's pow_const (a squaring a bit
// of p - 2 and a multiply a set bit) and its backward products, which the
// JAX package runs as one multiply a step and the port ran as one mod_mul
// launch a step: 1268 launches an affine_canon on secp256k1, 1271 on
// ed25519, 1373 on BLS12-381, each over one row of 1368 lanes at n = 1024.
// Here one launch runs every step: the prefixes live in the output's own
// rows, the total and the running inverse in registers, and the Fermat
// inversion follows a sliding-window chain of p - 2 (ops/field_kernels.py
// inv_chain: 318, 316 and 460 multiplies with window 5, against pow_const's
// 503, 506 and 608), read from a table every thread reads alike.
//
// What bounds it on the H100: neither bytes nor multiplies but the chain's
// latency.  A column is rows - 1 + chain + 2 (rows - 1) dependent
// multiplies, while the function needs 3 multiplies a lane and one chain
// in all: at 350,208 lanes on secp256k1 0.011 ms of the multiplier's
// rate, under the 0.013 ms that its bytes take (each element read once,
// each inverse written once).  So the rows a column holds (the wrapper's
// caller picks them: groups/device.py INV_ROWS) trade the chain's length
// against the columns in flight: fewer rows, more columns, a shorter
// chain.  One thread a column: a column on a group of threads
// (group.cuh's CIOS multiply, its word loop over 8 or 4 threads) was
// built, timed and found slower at every shape the paths give (PERF.md
// has the times), as a lone product's N steps each wait on the group's
// shuffles and only independent products in lockstep hide them.
#include <cuda_runtime.h>

#include "inv.cuh"
#include "lanes.cuh"

namespace {

using namespace dkg;

// x and out (rows, cols, 2N): thread c takes column c, its rows cols 2N
// limbs apart.
template <int F>
__global__ void __launch_bounds__(kThreads)
    mod_batch_inv_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t rows,
                         int64_t cols, const int32_t* __restrict__ chain, int chain_len, int npow) {
  constexpr int L = 2 * Field<F>::N;
  DKG_LANES(col, cols) {
    batch_inv_column<F>(x + col * L, out + col * L, rows, cols * L, chain, chain_len, npow);
  }
}

template <int F>
int launch_batch_inv(const int32_t* x, int32_t* out, int64_t rows, int64_t cols,
                     const int32_t* chain, int chain_len, int npow, cudaStream_t s) {
  const int64_t blocks = (cols + kThreads - 1) / kThreads;
  mod_batch_inv_kernel<F><<<(unsigned)blocks, kThreads, 0, s>>>(x, out, rows, cols, chain,
                                                                 chain_len, npow);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// x, out (rows, cols, L) int32 limbs; chain (chain_len) the Fermat chain
// over npow odd powers; field: the ids of field.cuh, 0 (secp256k1 p),
// 2 (ed25519 p) or 4 (BLS12-381 p).
int dkg_mod_batch_inv(const int32_t* x, int32_t* out, int64_t rows, int64_t cols,
                      const int32_t* chain, int chain_len, int npow, int field, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (chain_len < 1 || npow < 1 || npow > kInvMaxPowers || cols > 0x7FFFFFFFLL * kThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case kSecpP: return launch_batch_inv<kSecpP>(x, out, rows, cols, chain, chain_len, npow, s);
    case kEdP: return launch_batch_inv<kEdP>(x, out, rows, cols, chain, chain_len, npow, s);
    case kBlsP: return launch_batch_inv<kBlsP>(x, out, rows, cols, chain, chain_len, npow, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
