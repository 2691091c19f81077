// mxu_mod_mul: out = (a * b) mod p by the fused multiply-reduce of
// mxu.cuh, over any of the six fields at L = 16 limbs (secp256k1 p and n,
// ed25519 p, ristretto255 l, BLS12-381 r) or L = 24 (BLS12-381 p); and
// mxu_batch_inv: a whole Montgomery-trick batch inversion in one launch
// with every multiply the same fused multiply-reduce, over the three base
// fields whose points groups/device.py affine_canon makes affine.
//
// Replaces: dkg_tpu/ops/pallas_mxu.py _mxu_mul_tiles (the Pallas kernel
// behind mxu_mod_mul), the JAX package's multiply-reduce on its matrix
// unit: the digit fold there is one float32 matrix product against
// foldm, and the quotient a two-level one-hot matrix product, because
// the TPU has no gather.  Here the quotient is one load from the table
// and the fold an exact integer product: in the one-step kernel one lane
// a thread, four byte products an instruction (__dp4a, mxu.cuh); in
// mxu_batch_inv a warp's 32 lanes at once on the tensor cores
// (mxu_warp.cuh: the TPU kernel's one matrix product a tile of lanes,
// mma.sync on u8 with s32 sums).  The one-step kernel was also built with
// the tensor-core fold and measured slower at every path shape on the
// H100 (PERF.md), so it keeps __dp4a.  No float anywhere.
//
// mxu_batch_inv replaces the same kernel composed over the chain of
// dkg_tpu/fields/device.py batch_inv (forward prefix products, the Fermat
// inversion, backward products), which the JAX package runs as one
// multiply a step and the port ran under mul="gemm" as one mxu_mod_mul
// launch a step: 2540 launches an affine_canon pair on secp256k1, 2548 on
// ed25519, 2750 on BLS12-381.  It is csrc/inv.cuh's mod_batch_inv column
// (one thread a column, the prefixes in the output's rows, the
// sliding-window chain of p - 2 from ops/field_kernels.py inv_chain) with
// every multiply a warp's tensor-core multiply-reduce (mxu_warp.cuh
// mxu_batch_inv_column): a warp holds 32 columns, which run the same
// chain in lockstep, so the fold is one m16n8k32 product set a multiply
// for all 32.  The wrapper pads the columns to a multiple of 32 with ones.
//
// What bounds them on the H100: the one-step kernel reads two elements and
// writes one, 3 x 64 bytes at L = 16 (3 x 96 at L = 24), 57 ps (86 ps) a
// lane at 3.35 TB/s.  Its work: L^2 16x16-bit multiplies for the columns
// (256; 576), the fold's (3L + 1) x 2L byte products (1568; 3504), and
// n_split x L + L + 1 small multiplies for the folds and the quotient.  At
// the 32-bit multiply rate (16.7 T/s) the columns alone take 15 ps (34
// ps) a lane; counted as int8 products at the tensor cores' 1979 T/s the
// fold takes 1.6 ps (3.5 ps), against 416 (912) __dp4a a lane on the CUDA
// cores.  So the bytes bound it; the columns and the fold's issue set its
// time.  The batch inversion needs 3 (lanes - 1) multiplies and one
// Fermat chain, and is bound by neither bytes nor multiplies but its
// dependent chain: rows - 1 + chain + 2 (rows - 1) multiplies a column,
// each now a warp-synchronous step (stage, two syncs, 16 or 36 mma), so
// the rows (groups/device.py GEMM_INV_ROWS) trade chain length against
// columns in flight, as INV_ROWS does for mod_batch_inv.
//
// The design keeps a lane's limbs, columns and packed digits in
// registers.  The one-step kernel's blocks first stage the field's
// constants (foldm transposed and packed four bytes a word, the quotient
// table, c and b^(L+1) - p; 10 to 13 KB) in shared memory, where every
// thread of a warp reads the same foldm word at once (a broadcast) and the
// table by its own index.  mxu_batch_inv stages the table, c and
// b^(L+1) - p likewise and holds foldm as A fragments in registers; each
// warp has its two staging buffers (7.5 KB, or 11.25 KB at L = 24) after
// them, in blocks of two warps.  The wrapper (ops/mxu_kernels.py) builds the
// constants once per field and device from FieldSpec.mulred, so the
// kernels take only the repo's sources and no generated code.
#include <cuda_runtime.h>

#include "lanes.cuh"
#include "mxu_warp.cuh"

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

constexpr int kWarpThreads = 64;  // mxu_batch_inv's blocks: two warps

// The constants mxu_batch_inv stages: the quotient table, c and
// b^(L+1) - p, then each warp's buffers (on an even word).
template <int L>
__host__ __device__ constexpr int warp_const_words(int nq) {
  return (nq + 2 * L + 1 + 1) & ~1;
}

template <int L>
size_t warp_smem_bytes(int nq) {
  return sizeof(uint32_t) * (warp_const_words<L>(nq) + (kWarpThreads / 32) * MxuTiles<L>::kWords);
}

// The block's constants in shared memory.
template <int L>
__device__ __forceinline__ MulRed stage_warp_consts(uint32_t* smem, const uint32_t* qtable, int nq,
                                                    const uint32_t* c, const uint32_t* np,
                                                    int n_split, int shift_e) {
  uint32_t* s_q = smem;
  uint32_t* s_c = s_q + nq;
  for (int i = threadIdx.x; i < nq; i += blockDim.x) s_q[i] = qtable[i];
  for (int i = threadIdx.x; i < 2 * L + 1; i += blockDim.x) s_c[i] = i < L ? c[i] : np[i - L];
  __syncthreads();
  return MulRed{nullptr, s_q, s_c, s_c + L, n_split, shift_e};
}

// mxu_batch_inv: thread c inverts column c of x (rows, cols, L) into out;
// cols is a multiple of 32, so a warp is 32 columns or none.
template <int L>
__global__ void __launch_bounds__(kWarpThreads)
    mxu_batch_inv_kernel(const int32_t* __restrict__ x, int32_t* __restrict__ out, int64_t rows,
                         int64_t cols, const uint32_t* __restrict__ foldm,
                         const uint32_t* __restrict__ qtable, int nq, const uint32_t* __restrict__ c,
                         const uint32_t* __restrict__ np, int n_split, int shift_e,
                         const int32_t* __restrict__ chain, int chain_len, int npow) {
  extern __shared__ uint32_t smem[];
  const MulRed k = stage_warp_consts<L>(smem, qtable, nq, c, np, n_split, shift_e);
  const int64_t col = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (col - (threadIdx.x & 31) >= cols) return;  // the whole warp
  const int lane = threadIdx.x & 31;
  const CudaWarp w{smem + warp_const_words<L>(nq) + (threadIdx.x >> 5) * MxuTiles<L>::kWords, lane};
  MxuFrags<L> fr;
  mxu_load_frags<L>(fr, foldm, lane);
  mxu_batch_inv_column<L>(w, x + col * L, out + col * L, rows, cols * L, chain, chain_len, npow, k,
                          fr);
}

template <int L>
int launch_batch_inv(const int32_t* x, int32_t* out, int64_t rows, int64_t cols,
                     const uint32_t* foldm, const uint32_t* qtable, int nq, const uint32_t* c,
                     const uint32_t* np, int n_split, int shift_e, const int32_t* chain,
                     int chain_len, int npow, cudaStream_t s) {
  const int64_t blocks = (cols + kWarpThreads - 1) / kWarpThreads;
  mxu_batch_inv_kernel<L><<<(unsigned)blocks, kWarpThreads, warp_smem_bytes<L>(nq), s>>>(
      x, out, rows, cols, foldm, qtable, nq, c, np, n_split, shift_e, chain, chain_len, npow);
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

// x, out (rows, cols, limbs) int32 limbs, cols a multiple of 32; the
// field's constants as dkg_mxu_mod_mul takes them; chain (chain_len) the
// Fermat chain of p - 2 over npow odd powers (csrc/inv.cuh).
int dkg_mxu_batch_inv(const int32_t* x, int32_t* out, int64_t rows, int64_t cols, int limbs,
                      const void* foldm, const uint32_t* qtable, int nq, const uint32_t* c,
                      const uint32_t* np, int n_split, int shift_e, const int32_t* chain,
                      int chain_len, int npow, void* stream) {
  if (rows <= 0 || cols <= 0) return 0;
  if (nq <= 0 || nq > kMaxTable || shift_e < 0 || shift_e > 16 || n_split < 0 || cols % 32 != 0 ||
      chain_len < 1 || npow < 1 || npow > kInvMaxPowers || cols > 0x7FFFFFFFLL * kWarpThreads)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const uint32_t* f = (const uint32_t*)foldm;
  switch (limbs) {
    case 16:
      return launch_batch_inv<16>(x, out, rows, cols, f, qtable, nq, c, np, n_split, shift_e, chain,
                                  chain_len, npow, s);
    case 24:
      return launch_batch_inv<24>(x, out, rows, cols, f, qtable, nq, c, np, n_split, shift_e, chain,
                                  chain_len, npow, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

const char* dkg_error_string(int err) { return cudaGetErrorString((cudaError_t)err); }

}  // extern "C"
