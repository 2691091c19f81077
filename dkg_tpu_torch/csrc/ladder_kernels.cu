// pt_ladder_horner: the point Horner of eval_point_poly in one launch,
// acc <- x acc + D_l for l = T-1 .. 0 from the identity, each step
// pt_ladder_mul_add's (point_kernels.cuh, edwards_kernels.cu), with a
// lane spread over a group of TPI threads (group.cuh), on secp256k1,
// BLS12-381 G1 and edwards25519 (ristretto255).
//
// Replaces: dkg_tpu/ops/pallas_point.py _ladder_call (the Pallas kernel
// behind pt_ladder_mul_add), composed T times: the JAX package launches it
// once per Horner step of dkg_tpu/groups/device.py eval_point_poly.  The
// output equals T launches of the one-step kernel limb for limb: the same
// RCB15 / hwcd formulas in the same order over exact field ops (Montgomery
// form inside, canonical limbs at both ends), and what the one-step
// ladder's select throws away is not computed (group.cuh
// ladder_horner_lane).
//
// What bounds it on the H100: the multiplier.  At the ceremony's RHS
// (T = 342 shared coefficients, x = 1..1024, nbits = 11) a lane needs
// (bit_length(x) - 1) doublings and popcount(x) adds a step, 10889 (secp256k1)
// and 45096 (BLS12-381) multiply-adds on average in field.cuh's counts,
// 0.0013 ms and 0.0061 ms a step over 1024 lanes at 16.7 T 32-bit
// multiplies a second, while a step moves only the coefficient.
//
// What the design does about it.  The one-step kernel ran one thread a
// lane, 1024 threads in 8 blocks of a 132-SM card, 254-255 registers, a
// fixed nbits double-and-adds with the add of a zero bit computed and
// thrown away, and read and wrote the accumulator in device memory at
// each of 342 launches.  Here:
// - one launch: the accumulator stays in registers for all T steps; when
//   the coefficients are shared (rows == 1) each block converts them to
//   Montgomery words in shared memory once (T C N words: 32 KiB at
//   secp256k1's T = 342, 48 KiB on BLS12-381), and every lane reads D_l
//   as a broadcast.  They go through registers on the way in (the
//   conversion is a multiply), so a plain load does the copy, once a
//   block.  Per-lane coefficients (verify_pairwise) are read from device
//   memory at each step and converted there;
// - TPI threads a lane (a compile-time constant a curve: 8 on the 8-word
//   fields of secp256k1 and ed25519, 4 on BLS12-381 p's 12 words, which
//   8 does not divide): 8192 threads at 1024 lanes on secp256k1, a rank's
//   slice of each coordinate (1 word, or 3 of BLS12-381 p's 12) in
//   Montgomery form, the multiply's word loop spread over the group by
//   shuffles (group.cuh), and the independent multiplies and adds of each
//   formula run in lockstep so that their shuffles and ballots overlap.
//   The time fell with every doubling of TPI (ops/horner_bench.py; PERF.md
//   has the table);
// - a bit's add runs only where a group of the warp has the bit set, and,
//   on the Weierstrass curves (whose doubling fixes the stored identity),
//   a bit's doubling only where a group of the warp is past x's top set
//   bit; neighbouring lanes hold neighbouring x and share their high bits.
//   The decisions are the warp's (a vote), so every shuffle and ballot is
//   made by the whole warp and takes the full-warp mask: with per-group
//   masks and per-group branches, nvcc wrapped each of them in a
//   convergence sequence several times its length (PERF.md).
//
// DKG_TPI_SECP, DKG_TPI_BLS and DKG_TPI_ED choose TPI at build time
// (defaults below); ops/horner_bench.py builds and times the choices.
#include <cuda_runtime.h>

#include "group.cuh"

#ifndef DKG_TPI_SECP
#define DKG_TPI_SECP 8
#endif
#ifndef DKG_TPI_BLS
#define DKG_TPI_BLS 4
#endif
#ifndef DKG_TPI_ED
#define DKG_TPI_ED 8
#endif

namespace {

using namespace dkg;

constexpr int kLadderThreads = 128;

template <class K>
constexpr int stage_bytes(int T) {
  return T * K::kCoords * K::N * 4;
}

// coeffs: (rows, T, C, 2N) stored limbs, lane i's at row i / lanes_per_row
// (rows == 1 with staged: shared, converted into shared memory once).
template <template <class, class> class Kind, class C, int TPI>
__global__ void __launch_bounds__(kLadderThreads)
    pt_ladder_horner_kernel(const int32_t* __restrict__ coeffs, int64_t lanes_per_row,
                            bool staged, const int32_t* __restrict__ x, int32_t* __restrict__ out,
                            int64_t n, int T, int nbits) {
  using K = Kind<C, WarpGroup<TPI>>;
  extern __shared__ uint32_t words[];
  const K k{WarpGroup<TPI>(threadIdx.x)};
  const int64_t lane = ((int64_t)blockIdx.x * blockDim.x + threadIdx.x) / TPI;
  if (staged) {
    const int groups = blockDim.x / TPI;
    stage_coords(k, words, coeffs, (int64_t)T * K::kCoords, threadIdx.x / TPI, groups);
    __syncthreads();
  }
  // a group past the last lane runs the last lane's work without storing
  // it, so that the warp's control flow stays uniform
  const int64_t own = lane < n ? lane : n - 1;
  int32_t* dst = lane < n ? out + lane * K::kCoords * 2 * K::N : nullptr;
  if (staged) {
    ladder_horner_lane(k, StagedCoeffs<K>{words}, (uint32_t)x[own], nbits, T, dst);
  } else {
    const int32_t* row = coeffs + (own / lanes_per_row) * T * K::kCoords * 2 * K::N;
    ladder_horner_lane(k, LimbCoeffs<K>{row}, (uint32_t)x[own], nbits, T, dst);
  }
}

template <template <class, class> class Kind, class C, int TPI>
int launch(const int32_t* coeffs, int64_t rows, int64_t lanes_per_row, const int32_t* x,
           int32_t* out, int64_t n, int T, int nbits, cudaStream_t s) {
  using K = Kind<C, WarpGroup<TPI>>;
  if (n <= 0) return 0;
  if (nbits < 0 || nbits > 31 || T < 0 || rows < 1 || lanes_per_row < 1 ||
      rows * lanes_per_row != n)
    return (int)cudaErrorInvalidValue;
  auto kernel = pt_ladder_horner_kernel<Kind, C, TPI>;
  const int bytes = stage_bytes<K>(T);
  int max_bytes = 0, dev = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&max_bytes, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  // shared coefficients that do not fit in shared memory stream like per-lane ones
  const bool staged = rows == 1 && T > 0 && bytes <= max_bytes;
  if (staged && bytes > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (err != cudaSuccess) return (int)err;
  }
  const int64_t blocks = (n * TPI + kLadderThreads - 1) / kLadderThreads;
  kernel<<<(unsigned)blocks, kLadderThreads, staged ? bytes : 0, s>>>(coeffs, lanes_per_row,
                                                                      staged, x, out, n, T, nbits);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// coeffs (rows, T, C, L) int32 limbs, x (n,) int32, out (n, C, L); lane i
// evaluates row i / lanes_per_row at x[i]'s low nbits bits.
int dkg_pt_ladder_horner(const int32_t* coeffs, int64_t rows, int64_t lanes_per_row,
                         const int32_t* x, int32_t* out, int64_t n, int T, int nbits,
                         void* stream) {
  return launch<GroupWs, Secp256k1, DKG_TPI_SECP>(coeffs, rows, lanes_per_row, x, out, n, T,
                                                  nbits, (cudaStream_t)stream);
}

int dkg_bls_pt_ladder_horner(const int32_t* coeffs, int64_t rows, int64_t lanes_per_row,
                             const int32_t* x, int32_t* out, int64_t n, int T, int nbits,
                             void* stream) {
  return launch<GroupWs, Bls12381, DKG_TPI_BLS>(coeffs, rows, lanes_per_row, x, out, n, T,
                                                nbits, (cudaStream_t)stream);
}

int dkg_ed_pt_ladder_horner(const int32_t* coeffs, int64_t rows, int64_t lanes_per_row,
                            const int32_t* x, int32_t* out, int64_t n, int T, int nbits,
                            void* stream) {
  return launch<GroupEd, Edwards25519, DKG_TPI_ED>(coeffs, rows, lanes_per_row, x, out, n, T,
                                                   nbits, (cudaStream_t)stream);
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
