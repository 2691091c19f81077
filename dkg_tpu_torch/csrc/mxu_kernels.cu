// mxu_mod_mul: out = (a * b) mod p by the fused multiply-reduce of
// mxu.cuh, one lane per thread, over any of the six fields at L = 16
// limbs (secp256k1 p and n, ed25519 p, ristretto255 l, BLS12-381 r) or
// L = 24 (BLS12-381 p).
//
// Replaces: dkg_tpu/ops/pallas_mxu.py _mxu_mul_tiles (the Pallas kernel
// behind mxu_mod_mul), the JAX package's multiply-reduce on its matrix
// unit: the digit fold there is one float32 matrix product against
// foldm, and the quotient a two-level one-hot matrix product, because
// the TPU has no gather.  Here the fold is an exact integer dot product
// (__dp4a: four byte products a lane and instruction, accumulated in
// uint32; no float anywhere) and the quotient one load from the table.
// The port runs it as every multiply of the transcript digest's canonical
// affine form under mul="gemm" (groups/device.py affine_canon), in the
// place of mod_mul, so the two formulations meet on one path.
//
// What bounds it on the H100: a lane reads two elements and writes one,
// 3 x 64 bytes at L = 16 (3 x 96 at L = 24), 57 ps (86 ps) at 3.35 TB/s.
// Its work: L^2 16x16-bit multiplies for the columns (256; 576), the
// fold's (3L + 1) x 2L byte products (1568; 3504) as 13 x 32 = 416 (19 x
// 48 = 912) dp4a, and n_split x L + L + 1 small multiplies for the folds
// and the quotient.  At the 32-bit multiply rate (16.7 T/s) the columns
// alone take 15 ps (34 ps) a lane; counted as int8 products at the
// tensor cores' 1979 T/s, the fold would take 1.6 ps (3.5 ps).  So the
// bytes bound it, as they bound mod_mul; but it does several times
// mod_mul's integer instructions (field.cuh's core: 64 to 144 32-bit
// multiply-adds and a fold or Barrett), so a slower kernel than mod_mul
// is the expected finding.  A tensor-core fold (mma.sync on u8, or
// wgmma) is a later design.
//
// The design keeps a lane's limbs, columns and packed digits in
// registers; each block first stages the field's constants (foldm
// transposed and packed four bytes a word, the quotient table, c and
// b^(L+1) - p; 10 to 13 KB) in shared memory, where every thread of a
// warp reads the same foldm word at once (a broadcast) and the table by
// its own index.  The wrapper (ops/mxu_kernels.py) builds those buffers
// once per field and device from FieldSpec.mulred, so the kernel takes
// only the repo's sources and no generated code.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "mxu.cuh"

namespace {

using namespace dkg;

constexpr int kMaxTable = 8192;  // the admission proof caps u below 2^13

template <int L>
__global__ void __launch_bounds__(kThreads)
    mxu_mod_mul_kernel(const int32_t* __restrict__ a, const int32_t* __restrict__ b,
                       int32_t* __restrict__ out, int64_t n, const uint32_t* __restrict__ foldm,
                       const uint32_t* __restrict__ qtable, int nq, const uint32_t* __restrict__ c,
                       const uint32_t* __restrict__ np, int n_split, int shift_e) {
  constexpr int NF = 2 * L * mulred_words<L>();
  extern __shared__ uint32_t smem[];
  uint32_t* s_fold = smem;
  uint32_t* s_q = s_fold + NF;
  uint32_t* s_c = s_q + nq;
  uint32_t* s_np = s_c + L;
  for (int i = threadIdx.x; i < NF; i += blockDim.x) s_fold[i] = foldm[i];
  for (int i = threadIdx.x; i < nq; i += blockDim.x) s_q[i] = qtable[i];
  for (int i = threadIdx.x; i < 2 * L + 1; i += blockDim.x) s_c[i] = i < L ? c[i] : np[i - L];
  __syncthreads();
  const MulRed k{s_fold, s_q, s_c, s_np, n_split, shift_e};
  DKG_LANES(lane, n) { mxu_mul_lane<L>(a + lane * L, b + lane * L, out + lane * L, k); }
}

template <int L>
int launch(const int32_t* a, const int32_t* b, int32_t* out, int64_t n, const uint32_t* foldm,
           const uint32_t* qtable, int nq, const uint32_t* c, const uint32_t* np, int n_split,
           int shift_e, cudaStream_t s) {
  const size_t smem = sizeof(uint32_t) * (2 * L * mulred_words<L>() + nq + 2 * L + 1);
  mxu_mod_mul_kernel<L><<<blocks_for(n), kThreads, smem, s>>>(a, b, out, n, foldm, qtable, nq, c,
                                                              np, n_split, shift_e);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// limbs: 16 or 24.  foldm: (2 limbs, 4 K4) bytes, byte t of row m's word
// k being foldm[4k + t][m]; qtable: nq words; c: limbs words; np:
// limbs + 1 words (ops/mxu_kernels.py builds them).
int dkg_mxu_mod_mul(const int32_t* a, const int32_t* b, int32_t* out, int64_t n, int limbs,
                    const void* foldm, const uint32_t* qtable, int nq, const uint32_t* c,
                    const uint32_t* np, int n_split, int shift_e, void* stream) {
  if (n <= 0) return 0;
  if (nq <= 0 || nq > kMaxTable || shift_e < 0 || shift_e > 16 || n_split < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* f = (const uint32_t*)foldm;
  switch (limbs) {
    case 16: return launch<16>(a, b, out, n, f, qtable, nq, c, np, n_split, shift_e, s);
    case 24: return launch<24>(a, b, out, n, f, qtable, nq, c, np, n_split, shift_e, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
