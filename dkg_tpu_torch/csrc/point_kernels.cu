// Complete projective point kernels on secp256k1, one point per thread:
// pt_add, pt_madd, pt_window_step and pt_ladder_mul_add, the kernels of
// point_kernels.cuh instantiated for the Secp256k1 curve of point.cuh.
// Its pt_double is in double_kernels.cu, and the BLS12-381 G1 instances
// of the same kernels are in bls_kernels.cu.
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
// 20372 at nbits = 11, about 1.9 times what those x need.  The ceremony
// runs pt_ladder_horner (ladder_kernels.cu) in its place: all T Horner
// steps in one launch, without the adds of zero bits and the doublings
// before x's top set bit.  This kernel stays as the TPU kernel's one-step
// twin, the route that one is held against.
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
// pt_ladder_horner spreads a lane over a group of threads instead
// (group.cuh), each holding a slice of every coordinate.
//
// As the one-step route, the ladder is launched once per Horner step of
// eval_point_poly, over n = 1024 lanes at the ceremony's shape: 8 blocks
// of 128 threads on a 132-SM card, so one launch leaves most of the card
// idle.
#include "point_kernels.cuh"

using namespace dkg;

extern "C" {

int dkg_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n, void* stream) {
  return launch_pt_add<Secp256k1>(p, q, out, n, stream);
}

int dkg_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n, void* stream) {
  return launch_pt_madd<Secp256k1>(p, q, out, n, stream);
}

int dkg_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                       int n_doubles, void* stream) {
  return launch_pt_window_step<Secp256k1>(acc, entry, out, n, n_doubles, stream);
}

int dkg_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                          int32_t* out, int64_t n, int nbits, void* stream) {
  return launch_pt_ladder_mul_add<Secp256k1>(p, addend, x, out, n, nbits, stream);
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
