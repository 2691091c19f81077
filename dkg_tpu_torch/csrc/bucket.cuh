// The Pippenger scatter pass's per-bucket fold, one bucket per thread,
// shared by bucket_kernels.cu and bls_kernels.cu (the card) and
// host_check.cpp (the host).
//
// A bucket (b, w, e) is the complete-formula sum, in order of j, of the
// points P[b, j] whose window-w digit is e, starting from the identity:
// acc <- pt_add(acc, P[b, j]) with acc first, exactly the order in which
// the plain version (ops/bucket_kernels.py bucket_accumulate_plain, the
// JAX package's groups/device.py _bucket_scan) updates that bucket.  So
// the projective coordinates equal theirs limb for limb, with no atomics.
//
// The kernel (a thread per bucket, a warp per 32 batch rows of one
// bucket) and its launch, bucket_kernel<K> and bucket_launch<K> below,
// are for the card only; each curve's C entry instantiates them for its
// K.  bucket_kernels.cu says why a warp holds rows and not buckets.
#pragma once

#include "edwards.cuh"
#include "point.cuh"

namespace dkg {

// The curves as the fold sees them: a point type, its stored words, the
// identity, load, store and the complete add.
template <class C>
struct WsCurve {
  using P = Point<C>;
  static constexpr int kPointWords = point_words<C>();  // 48, or 72 on BLS12-381
  static __device__ __forceinline__ void identity(P& p) { set_identity(p); }
  static __device__ __forceinline__ void load(const int32_t* s, P& p) { load_point(s, p); }
  static __device__ __forceinline__ void store(int32_t* d, const P& p) { store_point(d, p); }
  static __device__ __forceinline__ void add(P& o, const P& a, const P& b) { pt_add(o, a, b); }
};

using SecpCurve = WsCurve<Secp256k1>;
using BlsCurve = WsCurve<Bls12381>;

struct EdCurve {
  using P = EdPoint;
  static constexpr int kPointWords = kEdCoords * kEdLimbs;  // 64
  static __device__ __forceinline__ void identity(P& p) { ed_set_identity(p); }
  static __device__ __forceinline__ void load(const int32_t* s, P& p) { load_ed(s, p); }
  static __device__ __forceinline__ void store(int32_t* d, const P& p) { store_ed(d, p); }
  static __device__ __forceinline__ void add(P& o, const P& a, const P& b) { ed_add(o, a, b); }
};

// acc <- acc + P_j, in order of j, for every j in [0, count) whose digit
// dig[j * dig_stride] is e.  pts points at P_0 of the run, stored
// contiguously.
template <class K>
__device__ __forceinline__ void bucket_fold(typename K::P& acc, const int32_t* pts,
                                            const int32_t* dig, int64_t dig_stride,
                                            int64_t count, int e) {
  for (int64_t j = 0; j < count; ++j) {
    if (dig[j * dig_stride] == e) {
      typename K::P q;
      K::load(pts + j * K::kPointWords, q);
      K::add(acc, acc, q);
    }
  }
}

#ifdef __CUDACC__

constexpr int kBucketRows = 32;                    // batch rows of a block: one warp's lanes
constexpr int kBucketThreads = kBucketRows * 8;    // and up to 8 buckets of one window

// Thread (b, w, e): bucket e of window w of batch row b, written once.
template <class K>
__global__ void __launch_bounds__(kBucketThreads)
    bucket_kernel(const int32_t* __restrict__ pts, const int32_t* __restrict__ digits,
                  int32_t* __restrict__ out, int64_t batch, int64_t m, int nw, int window,
                  int64_t dig_batch_stride) {
  const int64_t b = (int64_t)blockIdx.x * kBucketRows + threadIdx.x;
  const int w = blockIdx.y;
  const int e = blockIdx.z * blockDim.y + threadIdx.y;
  if (b >= batch) return;
  typename K::P acc;
  K::identity(acc);
  bucket_fold<K>(acc, pts + b * m * K::kPointWords, digits + b * dig_batch_stride + w, nw, m, e);
  K::store(out + ((b * nw + w) * ((int64_t)1 << window) + e) * K::kPointWords, acc);
}

// Launch bucket_kernel<K> over every bucket.  window must be 1, 2, 4 or
// 8; dig_batch_stride is 0 for digits shared by the batch, m * nw for one
// (m, nw) block per batch row.  Returns cudaGetLastError(), or
// cudaErrorInvalidValue for a shape the kernel does not take.
template <class K>
inline int bucket_launch(const int32_t* pts, const int32_t* digits, int32_t* out, int64_t batch,
                         int64_t m, int nw, int window, int64_t dig_batch_stride,
                         cudaStream_t stream) {
  if (batch <= 0 || nw <= 0) return 0;
  if (m < 0 || nw > 65535 || (window != 1 && window != 2 && window != 4 && window != 8))
    return (int)cudaErrorInvalidValue;
  const int entries = 1 << window;
  const int per_block = entries < 8 ? entries : 8;  // buckets of a block
  const int64_t row_blocks = (batch + kBucketRows - 1) / kBucketRows;
  if (row_blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)row_blocks, (unsigned)nw, (unsigned)(entries / per_block));
  const dim3 block(kBucketRows, per_block);
  bucket_kernel<K><<<grid, block, 0, stream>>>(pts, digits, out, batch, m, nw, window,
                                               dig_batch_stride);
  return (int)cudaGetLastError();
}

#endif  // __CUDACC__

}  // namespace dkg
