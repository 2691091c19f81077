// The fused multiply-reduce of mxu.cuh with its fold on the tensor cores:
// a warp's 32 lanes multiply in lockstep, and step 3, the fold
// cols8 = foldm^T digits, is one matrix product for the whole warp, as
// the JAX package's ops/pallas_mxu.py _mxu_mul_tiles runs it on the TPU's
// matrix unit: A = foldm^T (2L rows, K = 3L + 1 byte columns), shared by
// every lane, times B = the lanes' digits (K x 32 bytes).  Steps 1, 2 and
// 4 to 8 stay a lane's own, on its thread (mxu.cuh).
//
// The product runs as mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32:
// M = 2L is 2 (L = 16) or 3 (L = 24) m-tiles of 16 rows, N = 32 lanes 4
// n-tiles of 8, K = 49 or 73 digits 2 or 3 k-tiles of 32 (zero past the
// last digit): 16 or 36 mma a multiply.  Every digit and every byte of
// foldm is below 2^8, and the admission proof of FieldSpec.mulred
// (fields/spec.py) bounds every sum below 2^24, so the unsigned bytes'
// products summed in s32 are exact: the sums equal __dp4a's limb for
// limb, and so does the product mod p.
//
// Fragments, from the PTX ISA's tables for m16n8k32 with .u8 (groupID
// g = lane / 4, threadID_in_group t = lane % 4; element i of a register
// in its byte i % 4):
//   A (16 x 32, row): a_i at row g (i < 4 or 8 <= i < 12) else g + 8,
//     column 4t + (i & 3) (+ 16 for i >= 8), i = 0..15 in four registers;
//   B (32 x 8, col): b_i at row 4t + (i & 3) (+ 16 for i >= 4), column
//     g, i = 0..7 in two registers;
//   C, D (16 x 8, s32): c_i at row g (i < 2) else g + 8, column
//     2t + (i & 1).
// foldm's A fragments come straight from its packed words (row m, word q:
// bytes foldm[4q .. 4q + 3][m]): a thread holds words q = 8 kt + t and
// 8 kt + 4 + t of rows 16 mt + g and 16 mt + g + 8, loaded once a kernel
// (mxu_load_frags) and kept in registers (16 words, or 36 at L = 24).  A
// B register is four consecutive digits of one lane, one packed digit
// word: each lane stages its words in its column of a shared-memory
// buffer, and each thread reads words 8 kt + t and 8 kt + 4 + t of lane
// 8 nt + g.  The sums go back through a second buffer, row m of lane l,
// and each lane reads its own 2L.  Rows are kMxuStride = 40 words apart
// (32 lanes and 8 more), so a fragment's 32 loads, and each lane's reads
// of its column, fall in 32 distinct banks.
//
// A kind W names the warp: its staging words (buf), the thread's lane,
// sync (every lane's stores seen by every lane) and mma.  CudaWarp below
// is the card's; csrc/host_check.cpp runs the same bodies with a warp of
// 32 fibers and an mma built from the ISA's fragment tables.
#pragma once

#include "inv.cuh"
#include "mxu.cuh"

namespace dkg {

constexpr int kMxuStride = 40;  // words a staging row holds: 32 lanes and 8 of padding

template <int L>
struct MxuTiles {
  static constexpr int K = 3 * L + 1;       // digits
  static constexpr int KT = (K + 31) / 32;  // k-tiles of 32 digits: 2 or 3
  static constexpr int KW = 8 * KT;         // digit words a lane stages: 16 or 24
  static constexpr int MT = 2 * L / 16;     // m-tiles of 16 fold rows: 2 or 3
  static constexpr int NT = 4;              // n-tiles of 8 lanes
  static constexpr int kWords = (KW + 2 * L) * kMxuStride;  // a warp's two buffers
};

// A thread's A fragments of foldm^T, every m-tile and k-tile.
template <int L>
struct MxuFrags {
  uint32_t a[MxuTiles<L>::MT][MxuTiles<L>::KT][4];
};

// foldm packed as mxu_kernels.cu takes it: (2L, K4) words, row m's word q
// holding bytes foldm[4q .. 4q + 3][m].
template <int L>
__device__ __forceinline__ void mxu_load_frags(MxuFrags<L>& fr, const uint32_t* foldm, int lane) {
  using T = MxuTiles<L>;
  constexpr int K4 = mulred_words<L>();
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int mt = 0; mt < T::MT; ++mt)
#pragma unroll
    for (int kt = 0; kt < T::KT; ++kt)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int row = 16 * mt + g + ((i & 1) ? 8 : 0);
        const int word = 8 * kt + t + ((i & 2) ? 4 : 0);
        fr.a[mt][kt][i] = word < K4 ? foldm[row * K4 + word] : 0u;
      }
}

#ifdef __CUDACC__
// A warp of the card: buf is its kWords staging words in shared memory.
struct CudaWarp {
  uint32_t* buf;
  int lane;
  __device__ __forceinline__ void sync() const { __syncwarp(); }
  // d <- d + A B on one 16 x 8 x 32 tile
  __device__ __forceinline__ void mma(uint32_t d[4], const uint32_t a[4], const uint32_t b[2]) const {
    asm("mma.sync.aligned.m16n8k32.row.col.s32.u8.u8.s32 {%0, %1, %2, %3}, {%4, %5, %6, %7}, "
        "{%8, %9}, {%0, %1, %2, %3};"
        : "+r"(d[0]), "+r"(d[1]), "+r"(d[2]), "+r"(d[3])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
  }
};
#endif

// Steps 2 to 8 for the warp's 32 lanes at once (every lane of the warp
// calls it): r <- the value of the lane's 2L columns mod p.
template <int L, class W>
__device__ __forceinline__ void mxu_warp_reduce(const W& w, const uint32_t col[2 * L], uint32_t r[L],
                                                const MulRed& k, const MxuFrags<L>& fr) {
  using T = MxuTiles<L>;
  constexpr int K4 = mulred_words<L>(), S = kMxuStride;
  uint32_t dg[K4], v[L + 1];
  mxu_digits<L>(col, dg);
  uint32_t* bs = w.buf;              // digit word q of lane l at bs[q S + l]
  uint32_t* ds = w.buf + T::KW * S;  // fold row m of lane l at ds[m S + l]
#pragma unroll
  for (int q = 0; q < T::KW; ++q) bs[q * S + w.lane] = q < K4 ? dg[q] : 0u;
  w.sync();
  const int g = w.lane >> 2, t = w.lane & 3;
#pragma unroll
  for (int nt = 0; nt < T::NT; ++nt) {
    uint32_t b[T::KT][2];
#pragma unroll
    for (int kt = 0; kt < T::KT; ++kt) {
      b[kt][0] = bs[(8 * kt + t) * S + 8 * nt + g];
      b[kt][1] = bs[(8 * kt + 4 + t) * S + 8 * nt + g];
    }
#pragma unroll
    for (int mt = 0; mt < T::MT; ++mt) {
      uint32_t d[4] = {0u, 0u, 0u, 0u};
#pragma unroll
      for (int kt = 0; kt < T::KT; ++kt) w.mma(d, fr.a[mt][kt], b[kt]);
      uint32_t* o = ds + (16 * mt + g) * S + 8 * nt + 2 * t;
      o[0] = d[0];
      o[1] = d[1];
      o[8 * S] = d[2];
      o[8 * S + 1] = d[3];
    }
  }
  w.sync();
#pragma unroll
  for (int j = 0; j < L; ++j)
    v[j] = mxu_keep<L>(col, j) + ds[2 * j * S + w.lane] + (ds[(2 * j + 1) * S + w.lane] << 8);
  mxu_settle<L>(v, k);
  mxu_quotient<L>(v, r, k);
}

// r <- (x y) mod p for the warp's 32 lanes at once (every lane of the
// warp calls it); r may alias x or y.
template <int L, class W>
__device__ __forceinline__ void mxu_warp_mul(const W& w, const uint32_t x[L], const uint32_t y[L],
                                             uint32_t r[L], const MulRed& k, const MxuFrags<L>& fr) {
  uint32_t col[2 * L];
  mxu_columns<L>(x, y, col);
  mxu_warp_reduce<L>(w, col, r, k, fr);
}

template <int L>
__device__ __forceinline__ void copy_limbs(uint32_t r[L], const uint32_t a[L]) {
#pragma unroll
  for (int j = 0; j < L; ++j) r[j] = a[j];
}

// r <- x^e by the chain of csrc/inv.cuh fermat_chain (ops/field_kernels.py
// inv_chain), each multiply a warp's (r may not alias x).
template <int L, class W>
__device__ __forceinline__ void mxu_fermat(const W& w, uint32_t r[L], const uint32_t x[L],
                                           const int32_t* chain, int chain_len, int npow,
                                           const MulRed& k, const MxuFrags<L>& fr) {
  uint32_t pw[kInvMaxPowers][L], t[L];
  copy_limbs<L>(pw[0], x);
  if (npow > 1) mxu_warp_mul<L>(w, x, x, t, k, fr);
#pragma unroll 1
  for (int j = 1; j < npow; ++j) mxu_warp_mul<L>(w, pw[j - 1], t, pw[j], k, fr);
  copy_limbs<L>(r, pw[chain[0]]);
#pragma unroll 1
  for (int c = 1; c < chain_len; ++c) {
    const int op = chain[c];
    if (op < 0) {
      copy_limbs<L>(t, r);
    } else {
      copy_limbs<L>(t, pw[op]);
    }
    mxu_warp_mul<L>(w, r, t, r, k, fr);
  }
}

// csrc/inv.cuh batch_inv_column with every multiply a warp's: the column
// at x (rows elements, stride limbs apart) inverted into the column at out
// (the same layout), the prefixes P_0 .. P_(rows-2) kept in out's rows.
// The warp's 32 lanes are 32 columns, which run the same steps in
// lockstep.
template <int L, class W>
__device__ __forceinline__ void mxu_batch_inv_column(const W& w, const int32_t* x, int32_t* out,
                                                     int64_t rows, int64_t stride,
                                                     const int32_t* chain, int chain_len, int npow,
                                                     const MulRed& k, const MxuFrags<L>& fr) {
  uint32_t acc[L], xi[L], t[L];
  load_limbs<L>(x, acc);
#pragma unroll 1
  for (int64_t i = 1; i < rows; ++i) {
    store_limbs<L>(out + (i - 1) * stride, acc);  // P_(i-1)
    load_limbs<L>(x + i * stride, xi);
    mxu_warp_mul<L>(w, acc, xi, acc, k, fr);
  }
  mxu_fermat<L>(w, t, acc, chain, chain_len, npow, k, fr);
  copy_limbs<L>(acc, t);  // the inverse of P_(rows-1)
#pragma unroll 1
  for (int64_t i = rows - 1; i >= 1; --i) {
    load_limbs<L>(out + (i - 1) * stride, t);
    mxu_warp_mul<L>(w, acc, t, t, k, fr);  // x_i^-1 = P_i^-1 P_(i-1)
    load_limbs<L>(x + i * stride, xi);
    mxu_warp_mul<L>(w, acc, xi, acc, k, fr);  // P_(i-1)^-1
    store_limbs<L>(out + i * stride, t);
  }
  store_limbs<L>(out, acc);
}

}  // namespace dkg
