// Complete projective point kernels on BLS12-381 G1 (y^2 = x^3 + 4 over
// the 381-bit base field, 24 limbs), one point per thread: pt_add,
// pt_madd, pt_double, pt_window_step, pt_ladder_mul_add and the
// Pippenger scatter bucket_accumulate.
//
// Replaces: dkg_tpu/ops/pallas_point.py _add_call, _madd_call,
// _double_call, _window_call and _ladder_call, and
// dkg_tpu/ops/pallas_mxu.py _bucket_call, for the L = 24 curve.  Each
// kernel is the secp256k1 kernel's lane body (point.cuh, bucket.cuh)
// instantiated over the Bls12381 curve: the same RCB15 formulas over the
// 12-word field core (field.cuh, Barrett for p with mu = floor(2^768/p)),
// b3 = 12 as four exact adds.  Outputs equal the JAX package's limb for
// limb.  The ceremony launches every one but pt_double: the Weierstrass
// window step is one pt_window_step launch.  The kernels and their
// launchers are point_kernels.cuh's and bucket.cuh's, instantiated here
// for BLS12-381 G1 under C entries of its own.
//
// What bounds them on the H100: a point is 288 bytes in memory (3 x 24
// int32 limbs).  Per lane, in 32x32->64-bit multiply-adds (point.cuh, a
// field multiply 403): pt_add 4836 and pt_madd 4433 for 864 bytes moved,
// pt_double 3224 a doubling for 576, pt_window_step at k = 4
// 4 x 3224 + 4836 = 17732 for 864.  Counted as two 32-bit multiplies each
// at 16.7 T/s against 3.35 TB/s, pt_add takes 579 ps of multiplies to
// 258 ps of bytes a lane: every kernel here is bound by the multiplier,
// where the secp256k1 add and madd sat near the balance point.
// pt_ladder_mul_add's x is public, so x * P + A needs only
// (bit_length(x) - 1) x 3224 + popcount(x) x 4836; this ladder runs a
// fixed nbits doublings and adds, nbits x (3224 + 4836) + 4836 = 93496
// at nbits = 11.  The ceremony runs pt_ladder_horner (ladder_kernels.cu)
// in its place, which computes only what those x need; this one stays as
// the TPU kernel's one-step twin.  The scatter adds every point into one bucket of each
// window: at the ceremony's RLC (B = 342 columns, m = 1024, c = 8,
// nw = 16) 5,603,328 adds, 3.2 ms of multiplies to 0.15 ms of bytes.
//
// The design is point_kernels.cu's and bucket_kernels.cu's: every
// coordinate and temporary in registers for the whole sequence, the
// modulus and mu from __constant__ memory, no shared memory.  A point is
// 36 words here against 24 on secp256k1, and a multiply's wide product
// and quotient 25 + 26 words, so the add, the window step, the ladder
// and the bucket fold do not fit in the 255 registers a thread can have
// and spill to local memory; ptxas's counts are printed by chip_smoke.py
// and written down in PERF.md.  pt_ladder_horner spreads a lane over a
// group of threads (group.cuh), a slice of each coordinate a thread in
// Montgomery form, with no out-of-line multiply and no spill.
#include "bucket.cuh"
#include "point_kernels.cuh"

using namespace dkg;

extern "C" {

int dkg_bls_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n, void* stream) {
  return launch_pt_add<Bls12381>(p, q, out, n, stream);
}

int dkg_bls_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n, void* stream) {
  return launch_pt_madd<Bls12381>(p, q, out, n, stream);
}

int dkg_bls_pt_double(const int32_t* p, int32_t* out, int64_t n, int n_doubles, void* stream) {
  return launch_pt_double<Bls12381>(p, out, n, n_doubles, stream);
}

int dkg_bls_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                           int n_doubles, void* stream) {
  return launch_pt_window_step<Bls12381>(acc, entry, out, n, n_doubles, stream);
}

int dkg_bls_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                              int32_t* out, int64_t n, int nbits, void* stream) {
  return launch_pt_ladder_mul_add<Bls12381>(p, addend, x, out, n, nbits, stream);
}

// As dkg_bucket_accumulate (bucket_kernels.cu), for BLS12-381 G1 points.
int dkg_bls_bucket_accumulate(const int32_t* pts, const int32_t* digits, int32_t* out,
                              int64_t batch, int64_t m, int nw, int window,
                              int64_t dig_batch_stride, void* stream) {
  return bucket_launch<BlsCurve>(pts, digits, out, batch, m, nw, window, dig_batch_stride,
                                 (cudaStream_t)stream);
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
