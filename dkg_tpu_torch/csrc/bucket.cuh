// The Pippenger scatter pass's per-bucket fold, one bucket per thread,
// shared by bucket_kernels.cu (the card) and host_check.cpp (the host).
//
// A bucket (b, w, e) is the complete-formula sum, in order of j, of the
// points P[b, j] whose window-w digit is e, starting from the identity:
// acc <- pt_add(acc, P[b, j]) with acc first, exactly the order in which
// the plain version (ops/bucket_kernels.py bucket_accumulate_plain, the
// JAX package's groups/device.py _bucket_scan) updates that bucket.  So
// the projective coordinates equal theirs limb for limb, with no atomics.
#pragma once

#include "edwards.cuh"
#include "point.cuh"

namespace dkg {

// The two curve kinds as the fold sees them: a point type, its stored
// words, the identity, load, store and the complete add.
struct WsCurve {
  using P = Point;
  static constexpr int kPointWords = kCoords * kLimbs;  // 48
  static __device__ __forceinline__ void identity(P& p) { set_identity(p); }
  static __device__ __forceinline__ void load(const int32_t* s, P& p) { load_point(s, p); }
  static __device__ __forceinline__ void store(int32_t* d, const P& p) { store_point(d, p); }
  static __device__ __forceinline__ void add(P& o, const P& a, const P& b) { pt_add(o, a, b); }
};

struct EdCurve {
  using P = EdPoint;
  static constexpr int kPointWords = kEdCoords * kLimbs;  // 64
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

}  // namespace dkg
