// pt_bucket_sum and pt_bucket_close: Pippenger's scatter and bucket close,
// one launch each, on secp256k1, BLS12-381 G1 and edwards25519
// (ristretto255), with a lane on one thread (csrc/chain.cuh LaneWs /
// LaneEd), but the close on secp256k1 and BLS12-381, whose lane is a group
// of TPI threads (group.cuh, Montgomery form inside, canonical limbs at
// both ends).  Each curve's setting is the one that measured fastest at
// its point RLC's shape, and no other variant is built: a group lost for
// the sum on every curve and for ristretto255's close, one thread for the
// other two closes (ops/bucket_bench.py; PERF.md has the times).  The
// bodies are csrc/pippenger.cuh's.
//
// pt_bucket_sum replaces dkg_tpu/ops/pallas_mxu.py _bucket_call (the
// Pallas kernel behind bucket_accumulate) where the digits are shared by
// the batch: the point RLC's, whose weights are the same for every
// column.  The TPU kernel keeps the whole bucket tile in VMEM and walks
// the m points in order, gathering and scattering bucket rows by one-hot
// matrix products; the port's bucket_accumulate gives a thread a bucket
// and has it scan all m digits for its own.  Here a stable counting sort
// of each window's digits (index preparation on the host side of the
// launch) gives every bucket its list of points in order of j, and lane
// (w, e, b) adds exactly those, with no scan.  The points are read in
// place through strides, in the (m, B, C, L) order in which the ceremony
// holds them: the 32 lanes of a warp are 32 neighbouring batch rows of
// one bucket, so they take the same list and read 32 neighbouring points
// at each step (no contiguous copy of the points).  The batch rows are
// padded to a warp's lanes (a padding lane runs the last row and stores
// nothing), so a warp never splits between two buckets and its steps stay
// uniform.  The buckets go out as (nw, 2^c - 1, B, C, L), coalesced.
//
// pt_bucket_close replaces _add_call (behind pt_add) composed over the
// close of dkg_tpu/groups/device.py _msm_pippenger_core, which the port
// ran as 2 (2^c - 1) pt_add launches in sequence over the B nw lanes (510
// at c = 8).  Here lane (w, b) runs the whole suffix sum with run and tot
// in registers, reading its buckets through strides (pt_bucket_sum's
// layout, or bucket_accumulate's for per-row digits), and writes tot once.
//
// What bounds them on the H100: the multiplier, as for every point
// kernel.  The sum needs B adds for every non-zero digit of every window
// (about B nw m (1 - 2^-c): 5.58 M complete adds on secp256k1 at the
// ceremony's B = 342, m = 1024, c = 8, nw = 16; 0.7 ms at 16.7 T 32-bit
// multiplies a second), over B nw (2^c - 1) lanes of a few adds each.
// The close needs 2 (2^c - 1) adds a lane, B nw lanes (2.79 M adds, 0.35
// ms), but they are one dependent chain of 510 adds a lane over only 5472
// lanes: one thread's add latency (about 8 us on secp256k1, 27 us on
// BLS12-381, alone on an SM) times 510 bounds it, which a group of threads
// shortens by batching each formula's independent products in lockstep
// (on secp256k1 and BLS12-381 at groups of 4: PERF.md).
#include <cuda_runtime.h>

#include "pippenger.cuh"

// The close's group sizes, set here and nowhere else (ops/bucket_bench.py
// builds and times others, 1 for one thread a lane).
#ifndef DKG_BUCKET_TPI_SECP
#define DKG_BUCKET_TPI_SECP 4
#endif
#ifndef DKG_BUCKET_TPI_BLS
#define DKG_BUCKET_TPI_BLS 4
#endif

namespace {

using namespace dkg;

// Threads a block: a lane on one thread holds a whole formula's
// temporaries, so four warps; a lane on a group a slice of them.
__host__ __device__ constexpr int bucket_threads(int tpi) { return tpi == 1 ? 128 : 256; }

// Batch rows padded to the lanes of a warp.
__host__ __device__ constexpr int64_t padded_rows(int64_t batch, int tpi) {
  return (batch + 32 / tpi - 1) / (32 / tpi) * (32 / tpi);
}

// Thread ((w nb + e - 1) bp + b) sums bucket e of window w of row b: the
// points at pts + b sb + j sj for j in order[w][starts[w][e] ..
// starts[w][e + 1]), into out ((w nb + e - 1) batch + b).  order (nw, m),
// starts (nw, nb + 2).  K: a one-thread kind of chain.cuh.
template <class K>
__global__ void __launch_bounds__(bucket_threads(1))
    pt_bucket_sum_kernel(const int32_t* __restrict__ pts, int64_t sb, int64_t sj,
                         const int32_t* __restrict__ order, const int32_t* __restrict__ starts,
                         int32_t* __restrict__ out, int64_t batch, int64_t m, int nw, int nb) {
  const int64_t bp = padded_rows(batch, 1);
  const int64_t lane = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (lane >= (int64_t)nw * nb * bp) return;  // a whole warp: bp is a multiple of 32
  const K kind{};
  const int64_t b = lane % bp, bucket = lane / bp;
  const int w = (int)(bucket / nb), e = (int)(bucket % nb) + 1;
  const int32_t* st = starts + (int64_t)w * (nb + 2);
  const int64_t own = b < batch ? b : batch - 1;
  bucket_sum_lane(kind, pts + own * sb, sj, order + (int64_t)w * m, st[e], st[e + 1] - st[e],
                  b < batch ? out + (bucket * batch + b) * stored_limbs<K>() : nullptr);
}

// Lane (w bp + b) closes the nb buckets of window w of row b at
// src + b sb + w sw + (e - 1) se into out (b nw + w).
template <template <class, class> class Kind, class C, int TPI>
__global__ void __launch_bounds__(bucket_threads(TPI))
    pt_bucket_close_kernel(const int32_t* __restrict__ src, int64_t sb, int64_t sw, int64_t se,
                           int32_t* __restrict__ out, int64_t batch, int nw, int nb) {
  using KA = KindAt<Kind, C, TPI>;
  using K = typename KA::type;
  const int64_t bp = padded_rows(batch, TPI);
  const int64_t lane = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / TPI;
  if (lane >= (int64_t)nw * bp) return;  // a whole warp
  const K kind = KA::make();
  const int64_t b = lane % bp;
  const int w = (int)(lane / bp);
  const int64_t own = b < batch ? b : batch - 1;
  bucket_close_lane(kind, src + own * sb + w * sw, se, nb,
                    b < batch ? out + (b * nw + w) * stored_limbs<K>() : nullptr);
}

inline int check_window(int nw, int nb) {
  return nw >= 1 && (nb == 1 || nb == 3 || nb == 15 || nb == 255) ? 0 : (int)cudaErrorInvalidValue;
}

template <class K>
int launch_sum(const int32_t* pts, int64_t sb, int64_t sj, const int32_t* order,
               const int32_t* starts, int32_t* out, int64_t batch, int64_t m, int nw, int nb,
               void* stream) {
  if (batch <= 0) return 0;
  if (m < 0 || check_window(nw, nb)) return (int)cudaErrorInvalidValue;
  constexpr int threads = bucket_threads(1);
  const int64_t blocks = ((int64_t)nw * nb * padded_rows(batch, 1) + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  pt_bucket_sum_kernel<K><<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      pts, sb, sj, order, starts, out, batch, m, nw, nb);
  return (int)cudaGetLastError();
}

template <template <class, class> class Kind, class C, int TPI>
int launch_close(const int32_t* src, int64_t sb, int64_t sw, int64_t se, int32_t* out,
                 int64_t batch, int nw, int nb, cudaStream_t s) {
  if (batch <= 0) return 0;
  if (check_window(nw, nb)) return (int)cudaErrorInvalidValue;
  constexpr int threads = bucket_threads(TPI);
  const int64_t blocks = ((int64_t)nw * padded_rows(batch, TPI) * TPI + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  pt_bucket_close_kernel<Kind, C, TPI><<<(unsigned)blocks, threads, 0, s>>>(src, sb, sw, se, out,
                                                                            batch, nw, nb);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Points: row b's point j at pts + b sb + j sj (int32 words, a point's C
// L limbs contiguous); order (nw, m) and starts (nw, nb + 2) from the
// digits' counting sort; nb = 2^window - 1; out (nw, nb, batch, C, L).
int dkg_pt_bucket_sum(const int32_t* pts, int64_t sb, int64_t sj, const int32_t* order,
                      const int32_t* starts, int32_t* out, int64_t batch, int64_t m, int nw, int nb,
                      void* stream) {
  return launch_sum<LaneWs<Secp256k1>>(pts, sb, sj, order, starts, out, batch, m, nw, nb, stream);
}

int dkg_bls_pt_bucket_sum(const int32_t* pts, int64_t sb, int64_t sj, const int32_t* order,
                          const int32_t* starts, int32_t* out, int64_t batch, int64_t m, int nw,
                          int nb, void* stream) {
  return launch_sum<LaneWs<Bls12381>>(pts, sb, sj, order, starts, out, batch, m, nw, nb, stream);
}

int dkg_ed_pt_bucket_sum(const int32_t* pts, int64_t sb, int64_t sj, const int32_t* order,
                         const int32_t* starts, int32_t* out, int64_t batch, int64_t m, int nw,
                         int nb, void* stream) {
  return launch_sum<LaneEd>(pts, sb, sj, order, starts, out, batch, m, nw, nb, stream);
}

// Buckets: row b's bucket e (1 .. nb) of window w at src + b sb + w sw +
// (e - 1) se (int32 words); out (batch, nw, C, L).
int dkg_pt_bucket_close(const int32_t* src, int64_t sb, int64_t sw, int64_t se, int32_t* out,
                        int64_t batch, int nw, int nb, void* stream) {
  return launch_close<GroupWs, Secp256k1, DKG_BUCKET_TPI_SECP>(src, sb, sw, se, out, batch, nw, nb,
                                                               (cudaStream_t)stream);
}

int dkg_bls_pt_bucket_close(const int32_t* src, int64_t sb, int64_t sw, int64_t se, int32_t* out,
                            int64_t batch, int nw, int nb, void* stream) {
  return launch_close<GroupWs, Bls12381, DKG_BUCKET_TPI_BLS>(src, sb, sw, se, out, batch, nw, nb,
                                                             (cudaStream_t)stream);
}

int dkg_ed_pt_bucket_close(const int32_t* src, int64_t sb, int64_t sw, int64_t se, int32_t* out,
                           int64_t batch, int nw, int nb, void* stream) {
  return launch_close<GroupEd, Edwards25519, 1>(src, sb, sw, se, out, batch, nw, nb,
                                                (cudaStream_t)stream);
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
