// mod_madd: out = (a * b + c) mod m, and mod_mul: out = (a * b) mod m,
// one lane per thread, over the secp256k1 base field p or group order n,
// the ed25519 base field 2^255 - 19, the ristretto255 scalar field l, or
// BLS12-381's base field p (24 limbs) and scalar field r.  And the two
// multi-step forms of mod_madd that the ceremony runs: mod_madd_horner
// (poly/device.py eval_many) and mod_madd_dot (dkg/ceremony.py _field_dot),
// each one launch.
//
// Replaces: dkg_tpu/ops/pallas_field.py _mod_madd_tiles (the Pallas
// kernel behind mod_madd), which the JAX package runs as the Horner step
// of poly/device.py eval_many; mod_madd_horner and mod_madd_dot compose
// the same step T (or m) times in one launch, so their outputs equal that
// many one-step launches limb for limb (every step ends in the canonical
// residue, and a modular sum's residue does not depend on the order of
// its terms).  And _mod_mul_tiles (behind the standalone mod_mul): the
// port runs it as every multiply of the transcript digest's canonical
// affine form (groups/device.py affine_canon: the batch inversion's chain
// over 256 rows of 1368 lanes at n = 1024, then x / Z and y / Z over all
// 350,208 commitments).  mod_mul is mod_madd without the addend: two
// elements read and one written, the same multiply-adds, so the same
// reasoning below bounds it by the bytes.
//
// What bounds the one-step kernels on the H100: a lane reads three
// elements and writes one (3 x 64 + 64 bytes at 16 limbs, 3 x 96 + 96 for
// BLS12-381 p), and does 86 (secp256k1 p), 134 (n), 73 (ed25519 p), 189
// (ristretto255 l, BLS12-381 r) or 403 (BLS12-381 p) 32x32->64-bit
// multiply-adds: N^2 for the schoolbook product, the rest for the
// reduction in field.cuh (folds, or Barrett for l, r and BLS12-381 p).
// Counted as two 32-bit multiplies each (low and high half) at the card's
// 16.7 T/s (132 SMs x 64 INT32 lanes x 1.98 GHz), 189 multiply-adds take
// 23 ps a lane, while 256 bytes at 3.35 TB/s take 76 ps (BLS12-381 p:
// 48 ps to 115 ps): memory is the bound, as long as the carry chains
// (each multiply-add also adds with carry) keep the integer work under
// it.  The design keeps the whole element in registers (8 or 12 words),
// loads and stores 16 bytes at a time, takes the reduction constants from
// __constant__ memory, and uses no shared memory.
//
// The multi-step forms are bound by the multiplier instead.  As T one-step
// launches, eval_many's Horner at n = 1024 (T = 342) read the accumulator,
// a broadcast copy of x and one of the coefficient (128 MiB of copies a
// step) and wrote the accumulator back, 342 times; mod_madd_horner gives a
// block one (coefficient row, tile of 128 points): each thread keeps its x
// and its accumulator in registers for all T steps and writes once, and
// the row's coefficients come into shared memory by cp.async, kHornerChunk
// at a time in two buffers (the next chunk's copy in flight while the
// block works on this one), read by every thread as a broadcast.  At
// n = 1024 that is T x 1M fmadds: 134 multiply-adds each on secp256k1 n
// (5.75 ms at 16.7 T/s), 189 on BLS12-381 r (8.10 ms), for 89 MB moved.
// _field_dot made m = n launches of n lanes each (8 blocks: launch-bound);
// mod_madd_dot gives a block 32 output lanes and 8 slices of the m rows:
// a warp reads 32 neighbouring values of one row (coalesced), each thread
// folds its slice through fmadd, and slice 0 adds the 8 partial sums.
#include <cuda_runtime.h>

#include "field.cuh"
#include "horner.cuh"
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

constexpr int kHornerThreads = 128;
constexpr int kDotLanes = 32, kDotSlices = 8;

__device__ __forceinline__ void copy_async16(void* smem, const void* gmem) {
  const uint32_t s = (uint32_t)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem));
}

// buf <- count stored coefficients at c (L limbs each), 16 bytes a
// thread at a time, as one cp.async group.
template <int L>
__device__ __forceinline__ void stage_chunk(int32_t* buf, const int32_t* c, int count) {
  const int pieces = count * L / 4;
  for (int i = threadIdx.x; i < pieces; i += blockDim.x) copy_async16(buf + 4 * i, c + 4 * i);
  asm volatile("cp.async.commit_group;\n" ::);
}

// The first coefficient of Horner chunk q (chunks run from the top).
__device__ __forceinline__ int chunk_lo(int T, int q) {
  const int lo = T - (q + 1) * kHornerChunk;
  return lo > 0 ? lo : 0;
}

// out[row, pt] = sum_l c[row, l] x[row, pt]^l: coeffs (rows, T, L) with
// row stride coeff_stride limbs (0: shared), xs (rows, npts, L) with
// stride xs_stride (0: shared), out (rows, npts, L); block b covers row
// b / tiles, points (b % tiles) * kHornerThreads + [0, kHornerThreads).
template <int F>
__global__ void __launch_bounds__(kHornerThreads)
    mod_madd_horner_kernel(const int32_t* __restrict__ coeffs, int64_t coeff_stride,
                           const int32_t* __restrict__ xs, int64_t xs_stride,
                           int32_t* __restrict__ out, int64_t npts, int64_t tiles, int T) {
  constexpr int N = Field<F>::N;
  constexpr int L = 2 * N;
  __shared__ __align__(16) int32_t buf[2][kHornerChunk * L];
  const int64_t row = blockIdx.x / tiles;
  const int64_t pt = (blockIdx.x % tiles) * kHornerThreads + threadIdx.x;
  const bool live = pt < npts;
  const int32_t* c = coeffs + row * coeff_stride;
  uint32_t x[N], acc[N];
#pragma unroll
  for (int k = 0; k < N; ++k) acc[k] = 0;
  if (live) load_elem<N>(xs + row * xs_stride + pt * L, x);
  const int chunks = (T + kHornerChunk - 1) / kHornerChunk;
  if (chunks > 0) stage_chunk<L>(buf[0], c + chunk_lo(T, 0) * L, T - chunk_lo(T, 0));
  for (int q = 0; q < chunks; ++q) {
    const int lo = chunk_lo(T, q);
    if (q + 1 < chunks) {
      const int lo_next = chunk_lo(T, q + 1);
      stage_chunk<L>(buf[(q + 1) & 1], c + lo_next * L, lo - lo_next);
      asm volatile("cp.async.wait_group 1;\n" ::);
    } else {
      asm volatile("cp.async.wait_group 0;\n" ::);
    }
    __syncthreads();
    if (live) horner_steps<F>(acc, x, buf[q & 1], T - q * kHornerChunk - lo);
    __syncthreads();  // buf[q & 1] is refilled for chunk q + 2
  }
  if (live) store_elem<N>(out + (row * npts + pt) * L, acc);
}

// out[k] = sum_j w[j] v[j, k]: w (m, L), v (m, K, L), out (K, L).  A block
// is kDotLanes lanes (threadIdx.x) by kDotSlices slices of the rows
// (threadIdx.y, rows y, y + kDotSlices, ...).
template <int F>
__global__ void __launch_bounds__(kDotLanes * kDotSlices)
    mod_madd_dot_kernel(const int32_t* __restrict__ w, const int32_t* __restrict__ v,
                        int32_t* __restrict__ out, int64_t m, int64_t K) {
  constexpr int N = Field<F>::N;
  __shared__ uint32_t part[kDotSlices - 1][N][kDotLanes];  // word-major: no bank conflicts
  const int64_t k = (int64_t)blockIdx.x * kDotLanes + threadIdx.x;
  const int s = threadIdx.y;
  uint32_t acc[N];
#pragma unroll
  for (int i = 0; i < N; ++i) acc[i] = 0;
  if (k < K) dot_steps<F>(acc, w, v, m, K, k, s, kDotSlices);
  if (s > 0) {
#pragma unroll
    for (int i = 0; i < N; ++i) part[s - 1][i][threadIdx.x] = acc[i];
  }
  __syncthreads();
  if (s == 0 && k < K) {
    for (int q = 0; q < kDotSlices - 1; ++q) {
      uint32_t b[N];
#pragma unroll
      for (int i = 0; i < N; ++i) b[i] = part[q][i][threadIdx.x];
      fadd<F>(acc, acc, b);
    }
    store_elem<N>(out + k * 2 * N, acc);
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

template <int F>
int launch_horner(const int32_t* coeffs, int64_t coeff_stride, const int32_t* xs,
                  int64_t xs_stride, int32_t* out, int64_t rows, int64_t npts, int T,
                  cudaStream_t s) {
  const int64_t tiles = (npts + kHornerThreads - 1) / kHornerThreads;
  mod_madd_horner_kernel<F><<<(unsigned)(rows * tiles), kHornerThreads, 0, s>>>(
      coeffs, coeff_stride, xs, xs_stride, out, npts, tiles, T);
  return (int)cudaGetLastError();
}

template <int F>
int launch_dot(const int32_t* w, const int32_t* v, int32_t* out, int64_t m, int64_t K,
               cudaStream_t s) {
  const int64_t blocks = (K + kDotLanes - 1) / kDotLanes;
  mod_madd_dot_kernel<F><<<(unsigned)blocks, dim3(kDotLanes, kDotSlices), 0, s>>>(w, v, out, m, K);
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

// coeffs (rows, T, L) with row stride coeff_stride limbs (0: one row
// shared), xs (rows, npts, L) with row stride xs_stride (0: shared), out
// (rows, npts, L): out[r, i] = sum_l coeffs[r, l] xs[r, i]^l.  Coefficient
// rows 16-byte aligned.  field: as dkg_mod_madd's.
int dkg_mod_madd_horner(const int32_t* coeffs, int64_t coeff_stride, const int32_t* xs,
                        int64_t xs_stride, int32_t* out, int64_t rows, int64_t npts, int T,
                        int field, void* stream) {
  if (rows <= 0 || npts <= 0) return 0;
  if (T < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case kSecpP: return launch_horner<kSecpP>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T, s);
    case kSecpN: return launch_horner<kSecpN>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T, s);
    case kEdP: return launch_horner<kEdP>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T, s);
    case kEdL: return launch_horner<kEdL>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T, s);
    case kBlsP: return launch_horner<kBlsP>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T, s);
    case kBlsR: return launch_horner<kBlsR>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

// w (m, L), v (m, K, L), out (K, L): out[k] = sum_j w[j] v[j, k].  field:
// as dkg_mod_madd's.
int dkg_mod_madd_dot(const int32_t* w, const int32_t* v, int32_t* out, int64_t m, int64_t K,
                     int field, void* stream) {
  if (K <= 0) return 0;
  if (m < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  switch (field) {
    case kSecpP: return launch_dot<kSecpP>(w, v, out, m, K, s);
    case kSecpN: return launch_dot<kSecpN>(w, v, out, m, K, s);
    case kEdP: return launch_dot<kEdP>(w, v, out, m, K, s);
    case kEdL: return launch_dot<kEdL>(w, v, out, m, K, s);
    case kBlsP: return launch_dot<kBlsP>(w, v, out, m, K, s);
    case kBlsR: return launch_dot<kBlsR>(w, v, out, m, K, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
