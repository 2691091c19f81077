// The bodies of pt_bucket_sum and pt_bucket_close (pippenger_kernels.cu),
// Pippenger's scatter and bucket close over any point kind of chain.cuh
// (a lane on one thread, or on a group.cuh group of TPI threads).  Shared
// with csrc/host_check.cpp, which runs them on the host.
//
// pt_bucket_sum takes the digits shared by every batch row (the point
// RLC's weights) after a stable counting sort (ops/bucket_kernels.py
// bucket_lists): order[w] lists the points 0..m-1 by window-w digit, each
// digit's run in increasing j, and starts[w][e] is where digit e's run
// begins.  A lane is bucket e >= 1 of window w of batch row b: from the
// identity it adds exactly its points, in order of j, acc <- acc + P[b, j],
// the order in which the JAX package's groups/device.py _bucket_scan (and
// ops/bucket_kernels.py bucket_accumulate_plain) updates that bucket, so
// its projective coordinates equal theirs limb for limb; it scans no
// digit.  Bucket 0, which the close ignores, is not formed.
//
// pt_bucket_close is the JAX package's suffix sum over a lane's buckets
// 2^c - 1 .. 1 (groups/device.py _msm_pippenger_core's close), run = run +
// B_e then tot = tot + run, both from the identity, in that order: the
// same adds in the same order give the same limbs, which a split or
// reordered sum would not.
#pragma once

#include "chain.cuh"

namespace dkg {

// acc <- the sum from the identity of the count points at base +
// order[i] sj (i in [first, first + count)), in that order; out <- acc
// (nothing where out is null).
template <class K>
__device__ __forceinline__ void bucket_sum_lane(const K& k, const int32_t* base, int64_t sj,
                                                const int32_t* order, int64_t first, int64_t count,
                                                int32_t* out) {
  typename K::P acc, q;
  k.identity(acc);
#pragma unroll 1
  for (int64_t i = first; i < first + count; ++i) {
    k.load(q, base + (int64_t)order[i] * sj);
    k.add(acc, acc, q);
  }
  k.store(out, acc);
}

// tot <- sum over e of e B_e, B_e (e = 1 .. nb) at buckets + (e - 1) se:
// for e = nb .. 1, run <- run + B_e, tot <- tot + run; out <- tot
// (nothing where out is null).
template <class K>
__device__ __forceinline__ void bucket_close_lane(const K& k, const int32_t* buckets, int64_t se,
                                                  int nb, int32_t* out) {
  typename K::P run, tot, q;
  k.identity(run);
  k.identity(tot);
#pragma unroll 1
  for (int e = nb; e >= 1; --e) {
    k.load(q, buckets + (int64_t)(e - 1) * se);
    k.add(run, run, q);
    k.add(tot, tot, run);
  }
  k.store(out, tot);
}

}  // namespace dkg
