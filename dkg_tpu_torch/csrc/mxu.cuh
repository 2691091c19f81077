// The fused multiply-reduce (a * b) mod p of one lane, the body of
// mxu_kernels.cu's kernel and of its host check: the JAX package's
// ops/pallas_mxu.py mxu_mul_rows (and fields/device.py _mul_gemm), step
// for step, over L = 16 or 24 limbs of 16 bits.
//
// The field is not a template parameter: its constants come from
// FieldSpec.mulred (fields/spec.py, which proves every bound below with
// exact integers) through a MulRed of pointers, so one body serves all
// six fields.  Every value is a uint32 and no step can overflow one:
//   1. columns: P_c = sum of the low halves of a_i * b_j (i + j = c) and
//      the high halves (i + j + 1 = c), each < 2^22;
//   2. digits: the three bytes of each high column P_L .. P_2L-1 and
//      P_{L-1} >> 16, 3L + 1 of them, packed four to a word;
//   3. fold: cols8[m] = sum_i foldm[i][m] * digit[i], four byte products
//      an instruction (__dp4a), each sum < 2^24 by the admission proof;
//   4. the L kept columns plus cols8[2j] + (cols8[2j+1] << 8);
//   5. n_split scan-free column folds of the top spill through c = b^L mod p;
//   6. one carry normalize into L + 1 limbs;
//   7. u, the value's top bits, and q = qtable[u], a plain load;
//   8. w = v + q * (b^(L+1) - p) mod b^(L+1), then one conditional
//      subtraction of p, done as one more add of b^(L+1) - p whose carry
//      out says w >= p.
// Like field.cuh it compiles as plain host C++ too (host_check.cpp).
#pragma once

#include "field.cuh"

namespace dkg {

// One field's constants, as mxu_kernels.cu stages them in shared memory.
struct MulRed {
  const uint32_t* foldm;   // (2L, K4) words: byte t of word k of row m is foldm[4k + t][m]
  const uint32_t* qtable;  // quotient table, indexed by u
  const uint32_t* c;       // (L,) 16-bit limbs of b^L mod p
  const uint32_t* np;      // (L + 1,) 16-bit limbs of b^(L+1) - p
  int n_split;
  int shift_e;
};

template <int L>
__host__ __device__ constexpr int mulred_words() {  // K4: words of 3L + 1 packed digits
  return (3 * L + 1 + 3) / 4;
}

// c + the dot product of the four bytes of a and of b.
__device__ __forceinline__ uint32_t dot4(uint32_t a, uint32_t b, uint32_t c) {
#ifdef __CUDA_ARCH__
  return __dp4a(a, b, c);
#else
  for (int t = 0; t < 4; ++t) c += ((a >> (8 * t)) & 0xFFu) * ((b >> (8 * t)) & 0xFFu);
  return c;
#endif
}

// Step 1: col[0..2L) <- the unnormalized schoolbook columns of a * b
// (16-bit limbs in, L^2 16x16-bit products).
template <int L>
__device__ __forceinline__ void mxu_columns(const uint32_t a[L], const uint32_t b[L],
                                            uint32_t col[2 * L]) {
#pragma unroll
  for (int k = 0; k < 2 * L; ++k) col[k] = 0;
#pragma unroll
  for (int i = 0; i < L; ++i) {
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t p = a[i] * b[j];
      col[i + j] += p & 0xFFFFu;
      col[i + j + 1] += p >> 16;
    }
  }
}

// Step 2: dg <- the 3L + 1 digits of the columns, four bytes a word (the
// words past the last digit's zero).
template <int L>
__device__ __forceinline__ void mxu_digits(const uint32_t col[2 * L], uint32_t dg[]) {
  constexpr int K4 = mulred_words<L>();
#pragma unroll
  for (int w = 0; w < K4; ++w) dg[w] = 0;
#pragma unroll
  for (int i = 0; i < 3 * L + 1; ++i) {
    uint32_t d;
    if (i < L) {
      d = col[L + i] & 0xFFu;
    } else if (i < 2 * L) {
      d = (col[i] >> 8) & 0xFFu;
    } else if (i < 3 * L) {
      d = col[i - L] >> 16;
    } else {
      d = col[L - 1] >> 16;
    }
    dg[i / 4] |= d << (8 * (i % 4));
  }
}

// Step 4's kept part of limb j: the low columns, P_{L-1} without its spill.
template <int L>
__device__ __forceinline__ uint32_t mxu_keep(const uint32_t col[2 * L], int j) {
  return j < L - 1 ? col[j] : (col[L - 1] & 0xFFFFu);
}

// Steps 5 and 6: v[0..L) (step 4's limbs) <- L + 1 normalized limbs of
// the same value mod p.
template <int L>
__device__ __forceinline__ void mxu_settle(uint32_t v[L + 1], const MulRed& k) {
  for (int it = 0; it < k.n_split; ++it) {
    const uint32_t top = v[L - 1] >> 16;
    uint32_t prev = 0;
#pragma unroll
    for (int j = 0; j < L; ++j) {
      const uint32_t h = v[j] >> 16;
      v[j] = (v[j] & 0xFFFFu) + prev + top * k.c[j];
      prev = h;
    }
  }
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j < L; ++j) {
    const uint32_t s = v[j] + carry;
    v[j] = s & 0xFFFFu;
    carry = s >> 16;
  }
  v[L] = carry;
}

// Steps 2 to 6: v[0..L] <- L + 1 normalized limbs congruent to the
// columns' value mod p, the fold by __dp4a.
template <int L>
__device__ __forceinline__ void mxu_fold(const uint32_t col[2 * L], uint32_t v[L + 1],
                                         const MulRed& k) {
  constexpr int K4 = mulred_words<L>();
  uint32_t dg[K4];
  mxu_digits<L>(col, dg);
#pragma unroll
  for (int j = 0; j < L; ++j) {
    uint32_t lo = 0, hi = 0;
#pragma unroll
    for (int w = 0; w < K4; ++w) {
      lo = dot4(k.foldm[(2 * j) * K4 + w], dg[w], lo);
      hi = dot4(k.foldm[(2 * j + 1) * K4 + w], dg[w], hi);
    }
    v[j] = mxu_keep<L>(col, j) + lo + (hi << 8);
  }
  mxu_settle<L>(v, k);
}

// Steps 7 and 8: out[0..L) <- v mod p, for v below the bound the quotient
// table was built for.
template <int L>
__device__ __forceinline__ void mxu_quotient(const uint32_t v[L + 1], uint32_t out[L],
                                             const MulRed& k) {
  const uint32_t u = (v[L - 1] >> k.shift_e) | (v[L] << (16 - k.shift_e));
  const uint32_t q = k.qtable[u];
  uint32_t w[L + 1];
  uint32_t carry = 0;
#pragma unroll
  for (int j = 0; j <= L; ++j) {
    const uint32_t s = v[j] + q * k.np[j] + carry;
    w[j] = s & 0xFFFFu;
    carry = s >> 16;
  }
  // w - p = w + (b^(L+1) - p) mod b^(L+1), which carries out iff w >= p
  uint32_t d[L];
  carry = 0;
#pragma unroll
  for (int j = 0; j <= L; ++j) {
    const uint32_t s = w[j] + k.np[j] + carry;
    if (j < L) d[j] = s & 0xFFFFu;
    carry = s >> 16;
  }
#pragma unroll
  for (int j = 0; j < L; ++j) out[j] = carry ? d[j] : w[j];
}

// x[0..L) <- the L stored limbs at a, four at a time.
template <int L>
__device__ __forceinline__ void load_limbs(const int32_t* a, uint32_t x[L]) {
  const Limbs4* av = reinterpret_cast<const Limbs4*>(a);
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    const Limbs4 s = av[q];
    x[4 * q] = (uint32_t)s.x, x[4 * q + 1] = (uint32_t)s.y;
    x[4 * q + 2] = (uint32_t)s.z, x[4 * q + 3] = (uint32_t)s.w;
  }
}

template <int L>
__device__ __forceinline__ void store_limbs(int32_t* out, const uint32_t r[L]) {
  Limbs4* ov = reinterpret_cast<Limbs4*>(out);
#pragma unroll
  for (int q = 0; q < L / 4; ++q) {
    ov[q] = Limbs4{(int32_t)r[4 * q], (int32_t)r[4 * q + 1], (int32_t)r[4 * q + 2],
                   (int32_t)r[4 * q + 3]};
  }
}

// One lane: out <- (a * b) mod p, L stored limbs each.
template <int L>
__device__ __forceinline__ void mxu_mul_lane(const int32_t* a, const int32_t* b, int32_t* out,
                                             const MulRed& k) {
  uint32_t x[L], y[L], col[2 * L], v[L + 1], r[L];
  load_limbs<L>(a, x);
  load_limbs<L>(b, y);
  mxu_columns<L>(x, y, col);
  mxu_fold<L>(col, v, k);
  mxu_quotient<L>(v, r, k);
  store_limbs<L>(out, r);
}

}  // namespace dkg
