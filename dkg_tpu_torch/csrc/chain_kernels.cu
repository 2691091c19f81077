// pt_fixed_base, pt_scalar_mul and pt_tree_sum: the three chained point
// kernels, on secp256k1, BLS12-381 G1 and edwards25519 (ristretto255),
// each with a lane on one thread (field.cuh's core, csrc/chain.cuh LaneWs /
// LaneEd) and, where the wrapper's lane rule (ops/point_kernels.py) takes
// it, on a group of TPI threads (group.cuh, Montgomery form inside,
// canonical limbs at both ends): pt_fixed_base on secp256k1 and
// BLS12-381, below 2^15 lanes, pt_tree_sum on BLS12-381, at one column,
// and pt_scalar_mul on every curve at a recipient's opens' lanes.  No
// other group variant is built: each lost or tied to one thread a lane at
// the paths' shapes (ops/chain_bench.py; PERF.md has the table).
//
// pt_scalar_mul replaces dkg_tpu/ops/pallas_point.py _window_call (the
// Pallas kernel behind pt_window_step) composed over the windows of
// dkg_tpu/groups/device.py _scalar_mul_core: the JAX package runs one
// fused window step (4 doublings and a complete add) a 4-bit digit, 64 of
// them, each over a gathered copy of the lanes' table entries; the port
// ran each window as a torch.gather of the entries and one
// pt_window_step launch, the accumulator written out and read back every
// window (about 0.8 GB a window on secp256k1 at the KEM's 1,048,576
// lanes, 1.2 GB on BLS12-381).  Here one launch runs every window: each
// lane takes its digits from its scalar's limbs, reads the entry of its
// table where it lies (a table row shared by many lanes, the KEM's
// recipient key under every dealer's randomness, is read in place, never
// copied to the batch: at 1024 recipients the tables are 3.1 MB on
// secp256k1 and 4.7 MB on BLS12-381, in the 50 MB L2), keeps the
// accumulator in registers and writes it once.  What bounds it is the
// multiplier: 256 doublings and 64 adds a lane, 246,784 multiply-adds on
// secp256k1 (point.cuh's counts), 1,134,848 on BLS12-381, 191,552 on
// edwards25519: at the KEM's 1,048,576 lanes 31.0 ms and 142.3 ms, and at
// 65,536 lanes 1.50 ms, at 16.7 T 32-bit multiplies a second.  A
// recipient's opens are one scalar over n lanes (1024, or 256), a table
// a lane: one thread a lane leaves most of the card idle and waits on one
// multiply at a time, so there a lane runs on a group, whose formulas
// batch their independent products in lockstep.
//
// pt_fixed_base replaces dkg_tpu/ops/pallas_point.py _madd_call (the
// Pallas kernel behind pt_madd) composed once per window: the JAX package
// runs one gathered mixed add per window of dkg_tpu/groups/device.py
// _fixed_base_mul_core.  Here one launch runs all of a fixed_base_mul's
// windows (32 at the ceremony's 8-bit windows): each lane takes its digits
// from its scalar's limbs, reads each window's entry from the table in
// place (no gathered copy), keeps the accumulator in registers across the
// windows, and writes it once.  The table (1.57 MB on secp256k1, 2.10 MB
// on ristretto255, 2.36 MB on BLS12-381) stays in the 50 MB L2, so the
// only device-memory traffic is the scalars in and the points out.  What
// bounds it is the multiplier: 32 mixed adds a lane, 970 multiply-adds
// each on secp256k1 (field.cuh's counts), 4433 on BLS12-381, 584 on
// ristretto255: at the deal's 350,208 lanes 1.30 ms and 5.94 ms at
// 16.7 T 32-bit multiplies a second, two a multiply-add.  A lane on one
// thread needs no Montgomery conversion (secp256k1 p's fold multiply is
// 86 multiply-adds, against CIOS's 136); a lane on a group converts each
// entry's X and Y in (two multiplies a window), and fills the card at the
// verifier's 1024 lanes, where one thread a lane leaves most of it idle.
//
// pt_tree_sum replaces _add_call (behind pt_add) composed over the levels
// of dkg_tpu/groups/device.py _tree_reduce: one launch sums axis m of a
// batch of columns in the reference's order (csrc/chain.cuh tree_block),
// one block a column (or a chunk of 2^levels leaves of it: the wrapper
// then sums the chunks' tops in a second launch).  Level 1 reads the
// leaves, or in the gathered mode the per-point tables' entries under
// their digits, in place; the levels' nodes live in shared memory (512
// points at m = 1024: 48 KiB on secp256k1, 64 KiB on edwards25519, 72 KiB
// on BLS12-381, opted in above 48 KiB).  A Straus window's tree (342
// columns of 1024 points) needs 342 x 1023 adds, 0.044 ms on secp256k1 and
// 0.202 ms on BLS12-381 at the multiplier's rate; the wide first levels
// fill the card, the last ones are a few adds a column, where a lane's
// latency sets the time.
//
// The group sizes are set here and nowhere else: DKG_CHAIN_TPI_SECP
// (secp256k1's pt_fixed_base and pt_scalar_mul), DKG_CHAIN_TPI_BLS
// (BLS12-381's three) and DKG_CHAIN_TPI_ED (edwards25519's
// pt_scalar_mul), at the defaults below unless a build defines them; the
// wrapper passes only whether a call takes its group.  DKG_CHAIN_TPI1_BLOCKS, where it
// is set, asks ptxas to fit that many blocks of every one-thread kernel
// on an SM (fewer registers a thread) in place of the choice of
// min_blocks below.  ops/chain_bench.py builds and times other choices.
#include <cuda_runtime.h>

#include "chain.cuh"

#ifndef DKG_CHAIN_TPI_SECP
#define DKG_CHAIN_TPI_SECP 8
#endif
#ifndef DKG_CHAIN_TPI_BLS
#define DKG_CHAIN_TPI_BLS 4
#endif
#ifndef DKG_CHAIN_TPI_ED
#define DKG_CHAIN_TPI_ED 8
#endif

namespace {

using namespace dkg;

// Threads a block: a lane on one thread holds a whole point formula's
// temporaries (142-255 registers), so four warps; a lane on a group holds
// a slice of them.
__host__ __device__ constexpr int chain_threads(int tpi) { return tpi == 1 ? 128 : 256; }

// Blocks ptxas must fit on an SM: BLS12-381's one-thread tree three (at
// most 170 registers, where it takes 206: a Straus window's 342 columns
// then run in one wave on 132 SMs, not two), every other kernel ptxas's
// choice.
template <class C, int TPI, bool kTree>
__host__ __device__ constexpr int min_blocks() {
#ifdef DKG_CHAIN_TPI1_BLOCKS
  return TPI == 1 ? DKG_CHAIN_TPI1_BLOCKS : 1;
#else
  return TPI == 1 && kTree && C::N == 12 ? 3 : 1;
#endif
}

template <int TPI>
struct CudaBlock {
  __device__ __forceinline__ int groups() const { return blockDim.x / TPI; }
  __device__ __forceinline__ int group() const { return threadIdx.x / TPI; }
  __device__ __forceinline__ void sync() const { __syncthreads(); }
};

// table (nw, 2^window, C, 2N), k (n, klimbs) limbs, out (n, C, 2N).  A
// group past the last lane runs the last lane's work and stores nothing,
// so that the warp's collectives stay uniform.
template <template <class, class> class Kind, class C, int TPI>
__global__ void __launch_bounds__(chain_threads(TPI), (min_blocks<C, TPI, false>()))
    pt_fixed_base_kernel(const int32_t* __restrict__ table, const int32_t* __restrict__ k,
                         int32_t* __restrict__ out, int64_t n, int nw, int window, int klimbs) {
  using KA = KindAt<Kind, C, TPI>;
  using K = typename KA::type;
  const K kind = KA::make();
  const int64_t lane = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / TPI;
  const int64_t own = lane < n ? lane : n - 1;
  fixed_base_lane(kind, table, k + own * klimbs, nw, window,
                  lane < n ? out + lane * stored_limbs<K>() : nullptr);
}

// table rows (rows, 2^window, C, 2N), k (n, klimbs), out (n, C, 2N): lane
// i takes table row (i / per_row) % rows.  A lane past the last one runs
// the last lane's work and stores nothing, so that a warp's collectives
// stay uniform.
template <template <class, class> class Kind, class C, int TPI>
__global__ void __launch_bounds__(chain_threads(TPI), (min_blocks<C, TPI, false>()))
    pt_scalar_mul_kernel(const int32_t* __restrict__ table, int64_t rows, int64_t per_row,
                         const int32_t* __restrict__ k, int32_t* __restrict__ out, int64_t n, int nw,
                         int window, int klimbs) {
  using KA = KindAt<Kind, C, TPI>;
  using K = typename KA::type;
  const K kind = KA::make();
  const int64_t lane = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / TPI;
  const int64_t own = lane < n ? lane : n - 1;
  const int64_t row = (own / per_row) % rows;
  scalar_mul_lane(kind, table + (row << window) * stored_limbs<K>(), k + own * klimbs, nw, window,
                  lane < n ? out + lane * stored_limbs<K>() : nullptr);
}

// Block b sums chunk b % chunks of column b / chunks: leaves
// [chunk 2^levels, min(m, (chunk + 1) 2^levels)) of the column at
// src + column sb (with digits, under digits + column dsb), into
// out[column, chunk].
template <template <class, class> class Kind, class C, int TPI>
__global__ void __launch_bounds__(chain_threads(TPI), (min_blocks<C, TPI, true>()))
    pt_tree_sum_kernel(const int32_t* __restrict__ src, int64_t sb, int64_t sj,
                       const int32_t* __restrict__ digits, int64_t dsb, int64_t dsj,
                       int32_t* __restrict__ out, int64_t m, int levels) {
  using KA = KindAt<Kind, C, TPI>;
  using K = typename KA::type;
  extern __shared__ uint32_t words[];
  const K kind = KA::make();
  const int64_t chunks = ((m - 1) >> levels) + 1;
  const int64_t col = blockIdx.x / chunks, chunk = blockIdx.x % chunks;
  const int64_t first = chunk << levels;
  const int64_t rest = m - first, size = (int64_t)1 << levels;
  const Leaves<K> leaves{src + col * sb + first * sj, sj,
                         digits != nullptr ? digits + col * dsb + first * dsj : nullptr, dsj};
  tree_block(kind, CudaBlock<TPI>{}, words, leaves, rest < size ? rest : size, levels,
             out + (col * chunks + chunk) * stored_limbs<K>());
}

constexpr int kMaxLevels = 12;

template <template <class, class> class Kind, class C, int TPI>
int launch_fixed_base(const int32_t* table, const int32_t* k, int32_t* out, int64_t n, int nw,
                      int window, int klimbs, cudaStream_t s) {
  if (n <= 0) return 0;
  if (window < 1 || window > 16 || 16 % window != 0 || nw < 0 || nw * window > klimbs * 16)
    return (int)cudaErrorInvalidValue;
  constexpr int threads = chain_threads(TPI);
  const int64_t blocks = (n * TPI + threads - 1) / threads;
  pt_fixed_base_kernel<Kind, C, TPI><<<(unsigned)blocks, threads, 0, s>>>(table, k, out, n, nw,
                                                                          window, klimbs);
  return (int)cudaGetLastError();
}

template <template <class, class> class Kind, class C, int TPI>
int launch_scalar_mul(const int32_t* table, int64_t rows, int64_t per_row, const int32_t* k,
                      int32_t* out, int64_t n, int nw, int window, int klimbs, cudaStream_t s) {
  if (n <= 0) return 0;
  if (window < 1 || window > 16 || 16 % window != 0 || nw < 0 || nw * window > klimbs * 16 ||
      rows < 1 || per_row < 1)
    return (int)cudaErrorInvalidValue;
  constexpr int threads = chain_threads(TPI);
  const int64_t blocks = (n * TPI + threads - 1) / threads;
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  pt_scalar_mul_kernel<Kind, C, TPI><<<(unsigned)blocks, threads, 0, s>>>(
      table, rows, per_row, k, out, n, nw, window, klimbs);
  return (int)cudaGetLastError();
}

template <template <class, class> class Kind, class C, int TPI>
int launch_tree_sum(const int32_t* src, int64_t sb, int64_t sj, const int32_t* digits,
                    int64_t dsb, int64_t dsj, int32_t* out, int64_t cols, int64_t m, int levels,
                    cudaStream_t s) {
  using K = typename KindAt<Kind, C, TPI>::type;
  if (cols <= 0) return 0;
  if (m < 1 || levels < 0 || levels > kMaxLevels) return (int)cudaErrorInvalidValue;
  const int64_t blocks = cols * (((m - 1) >> levels) + 1);
  if (blocks > 0x7FFFFFFF) return (int)cudaErrorInvalidValue;
  auto kernel = pt_tree_sum_kernel<Kind, C, TPI>;
  const int bytes = (levels > 0 ? 1 << (levels - 1) : 1) * point_smem_words<K>() * 4;
  if (bytes > 48 * 1024) {
    int max_bytes = 0, dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    if (bytes > max_bytes) return (int)cudaErrorInvalidValue;
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  kernel<<<(unsigned)blocks, chain_threads(TPI), bytes, s>>>(src, sb, sj, digits, dsb, dsj, out,
                                                             m, levels);
  return (int)cudaGetLastError();
}

// group = 0: one thread a lane; else a group of TPI threads, where the
// entry builds one (TPI > 1), and refused where it does not (TPI = 0)
template <template <class, class> class Kind, class C, int TPI>
int fixed_base_at(int group, const int32_t* table, const int32_t* k, int32_t* out, int64_t n, int nw,
                  int window, int klimbs, void* stream) {
  if (group == 0)
    return launch_fixed_base<Kind, C, 1>(table, k, out, n, nw, window, klimbs, (cudaStream_t)stream);
  if constexpr (TPI > 1)
    return launch_fixed_base<Kind, C, TPI>(table, k, out, n, nw, window, klimbs, (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

template <template <class, class> class Kind, class C, int TPI>
int scalar_mul_at(int group, const int32_t* table, int64_t rows, int64_t per_row, const int32_t* k,
                  int32_t* out, int64_t n, int nw, int window, int klimbs, void* stream) {
  if (group == 0)
    return launch_scalar_mul<Kind, C, 1>(table, rows, per_row, k, out, n, nw, window, klimbs,
                                         (cudaStream_t)stream);
  if constexpr (TPI > 1)
    return launch_scalar_mul<Kind, C, TPI>(table, rows, per_row, k, out, n, nw, window, klimbs,
                                           (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

template <template <class, class> class Kind, class C, int TPI>
int tree_sum_at(int group, const int32_t* src, int64_t sb, int64_t sj, const int32_t* digits,
                int64_t dsb, int64_t dsj, int32_t* out, int64_t cols, int64_t m, int levels,
                void* stream) {
  if (group == 0)
    return launch_tree_sum<Kind, C, 1>(src, sb, sj, digits, dsb, dsj, out, cols, m, levels,
                                       (cudaStream_t)stream);
  if constexpr (TPI > 1)
    return launch_tree_sum<Kind, C, TPI>(src, sb, sj, digits, dsb, dsj, out, cols, m, levels,
                                         (cudaStream_t)stream);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// table (nw, 2^window, C, L), k (n, klimbs) int32 limbs, out (n, C, L)
int dkg_pt_fixed_base(const int32_t* table, const int32_t* k, int32_t* out, int64_t n, int nw,
                      int window, int klimbs, int group, void* stream) {
  return fixed_base_at<GroupWs, Secp256k1, DKG_CHAIN_TPI_SECP>(group, table, k, out, n, nw, window,
                                                               klimbs, stream);
}

int dkg_bls_pt_fixed_base(const int32_t* table, const int32_t* k, int32_t* out, int64_t n, int nw,
                          int window, int klimbs, int group, void* stream) {
  return fixed_base_at<GroupWs, Bls12381, DKG_CHAIN_TPI_BLS>(group, table, k, out, n, nw, window,
                                                             klimbs, stream);
}

int dkg_ed_pt_fixed_base(const int32_t* table, const int32_t* k, int32_t* out, int64_t n, int nw,
                         int window, int klimbs, int group, void* stream) {
  return fixed_base_at<GroupEd, Edwards25519, 0>(group, table, k, out, n, nw, window, klimbs,
                                                 stream);
}

// table rows (rows, 2^window, C, L), lane i's row (i / per_row) % rows; k
// (n, klimbs) int32 limbs, out (n, C, L); nw windows of window bits
int dkg_pt_scalar_mul(const int32_t* table, int64_t rows, int64_t per_row, const int32_t* k,
                      int32_t* out, int64_t n, int nw, int window, int klimbs, int group,
                      void* stream) {
  return scalar_mul_at<GroupWs, Secp256k1, DKG_CHAIN_TPI_SECP>(group, table, rows, per_row, k, out,
                                                               n, nw, window, klimbs, stream);
}

int dkg_bls_pt_scalar_mul(const int32_t* table, int64_t rows, int64_t per_row, const int32_t* k,
                          int32_t* out, int64_t n, int nw, int window, int klimbs, int group,
                          void* stream) {
  return scalar_mul_at<GroupWs, Bls12381, DKG_CHAIN_TPI_BLS>(group, table, rows, per_row, k, out,
                                                             n, nw, window, klimbs, stream);
}

int dkg_ed_pt_scalar_mul(const int32_t* table, int64_t rows, int64_t per_row, const int32_t* k,
                         int32_t* out, int64_t n, int nw, int window, int klimbs, int group,
                         void* stream) {
  return scalar_mul_at<GroupEd, Edwards25519, DKG_CHAIN_TPI_ED>(group, table, rows, per_row, k,
                                                                out, n, nw, window, klimbs, stream);
}

// cols columns of m points: column b's point j at src + b sb + j sj (int32
// words), or with digits entry digits[b dsb + j dsj] of the table there;
// out (cols, chunks, C, L), chunks of 2^levels points
int dkg_pt_tree_sum(const int32_t* src, int64_t sb, int64_t sj, const int32_t* digits, int64_t dsb,
                    int64_t dsj, int32_t* out, int64_t cols, int64_t m, int levels, int group,
                    void* stream) {
  return tree_sum_at<GroupWs, Secp256k1, 0>(group, src, sb, sj, digits, dsb, dsj, out, cols, m,
                                            levels, stream);
}

int dkg_bls_pt_tree_sum(const int32_t* src, int64_t sb, int64_t sj, const int32_t* digits,
                        int64_t dsb, int64_t dsj, int32_t* out, int64_t cols, int64_t m, int levels,
                        int group, void* stream) {
  return tree_sum_at<GroupWs, Bls12381, DKG_CHAIN_TPI_BLS>(group, src, sb, sj, digits, dsb, dsj,
                                                           out, cols, m, levels, stream);
}

int dkg_ed_pt_tree_sum(const int32_t* src, int64_t sb, int64_t sj, const int32_t* digits,
                       int64_t dsb, int64_t dsj, int32_t* out, int64_t cols, int64_t m, int levels,
                       int group, void* stream) {
  return tree_sum_at<GroupEd, Edwards25519, 0>(group, src, sb, sj, digits, dsb, dsj, out, cols, m,
                                               levels, stream);
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
