// bucket_accumulate: the scatter pass of Pippenger's MSM, on secp256k1
// (RCB15 complete add, point.cuh) and edwards25519 (HWCD unified add,
// edwards.cuh), one bucket per thread: bucket.cuh's kernel instantiated
// for each, under a C entry of its own.  The BLS12-381 G1 instance is in
// bls_kernels.cu.
//
// Replaces: dkg_tpu/ops/pallas_mxu.py _bucket_call (the Pallas kernel
// behind bucket_accumulate) for both curve kinds at 16 limbs.  Points
// (B, m, C, L) and window digits (m, nw), shared by the batch (stride 0),
// or (B, m, nw) -> buckets (B, nw, 2^c, C, L), each bucket bit for bit the
// plain version's (bucket.cuh).  Nothing of the TPU design is carried
// over: there the whole (C·L, nw·2^c) bucket tile stays in VMEM, and each
// grid step runs the m points in sequence, gathering and scattering every
// bucket row by one-hot f32 matmuls.  Here thread (b, w, e) owns bucket e
// of window w of batch row b, walks j = 0..m-1 in order and adds P[b, j]
// wherever digit[b, j, w] == e, keeping the sum in registers and writing
// it once at the end.
//
// The 32 lanes of a warp are 32 batch rows of one bucket (w, e).  Under
// shared digits (the RLC's weights) every lane then takes the same branch
// at every j: a warp runs exactly its bucket's adds, about m / 2^c, with
// all lanes busy, and reads each digit as one broadcast load.  (Giving a
// warp 32 buckets of one row instead makes it run an add whenever any of
// them takes the point, with one lane in 32 busy at c = 8; PERF.md has
// both mappings' times.)  A block is 32 rows by up to 8 buckets of one
// window.
//
// What bounds it on the H100: the adds.  Every point is added into one
// bucket per window, bucket 0 included, since the plain version's bucket
// tensor holds it: B · nw · m complete adds, 1056 multiply-adds each on
// secp256k1 and 657 on edwards25519, against reading the points once and
// writing the buckets once.  At the ceremony's RLC (secp256k1 B = 342,
// m = 1024, c = 8, nw = 16: 5,603,328 adds, 0.71 ms of multiplies to
// 0.10 ms of bytes; ristretto255 B = 86, m = 256, c = 4, nw = 32: 704,512
// adds, 0.055 ms to 0.005 ms) it is bound by the multiplier.  Per-row
// digits are taken too, but their lanes diverge.
#include <cuda_runtime.h>

#include "bucket.cuh"

using namespace dkg;

extern "C" {

// window must be 1, 2, 4 or 8; dig_batch_stride is 0 for digits shared by
// the batch, m * nw for one (m, nw) block per batch row.
int dkg_bucket_accumulate(const int32_t* pts, const int32_t* digits, int32_t* out, int64_t batch,
                          int64_t m, int nw, int window, int64_t dig_batch_stride, void* stream) {
  return bucket_launch<SecpCurve>(pts, digits, out, batch, m, nw, window, dig_batch_stride,
                                  (cudaStream_t)stream);
}

// As dkg_bucket_accumulate, for edwards25519 points.
int dkg_ed_bucket_accumulate(const int32_t* pts, const int32_t* digits, int32_t* out,
                             int64_t batch, int64_t m, int nw, int window,
                             int64_t dig_batch_stride, void* stream) {
  return bucket_launch<EdCurve>(pts, digits, out, batch, m, nw, window, dig_batch_stride,
                                (cudaStream_t)stream);
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
