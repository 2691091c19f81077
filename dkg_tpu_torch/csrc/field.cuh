// Modular arithmetic for the four 256-bit fields of the ported curves, one
// field element per thread, shared by every kernel in this directory:
// secp256k1's base field p and group order n, and ed25519's base field
// p = 2^255 - 19 and the ristretto255 scalar field l = 2^252 + delta.
//
// Storage format (the port's tensors, the JAX package's layout): 16
// little-endian 16-bit limbs, one per int32 word.  Inside a kernel an
// element is 8 little-endian 32-bit words: load16/store16 convert at the
// edges, and every op in between returns the canonical residue in [0, m),
// so the stored limbs equal the JAX package's limb for limb.
//
// A field is a template parameter F (the ids below, shared with
// ops/field_kernels.py); Field<F> names its reduction, and the modulus
// words sit in __constant__ kModulus[F].  The three reductions of a
// 512-bit product t = hi*2^256 + lo:
//   kFold256 (secp256k1 p and n, m = 2^256 - c with a short c: 33 bits
//     for p, 129 for n): three folds lo + hi*c bring t below
//     2^256 + 2^(4+cb), then one conditional subtraction (reduce_fold256).
//     64 + 22 = 86 multiply-adds for p, 64 + 70 = 134 for n.
//   kFold255 (ed25519 p): 2^256 = 38 and 2^255 = 19 mod p.  One fold
//     lo + 38*hi leaves up to 263 bits, one fold at bit 255 (q*19) brings
//     it below 2^255 + 2^12 < 2p, then one conditional subtraction
//     (reduce_fold255).  64 + 8 + 1 = 73 multiply-adds.
//   kBarrett (ristretto255 l): 2^256 mod l is about 2^252, so a fold
//     gains only 4 bits.  HAC 14.42 with b = 2^32, k = 8 and
//     mu = floor(2^512 / l) (the plain version's FieldSpec.barrett_mu):
//     for t < l^2 the quotient estimate is short by at most 1, fixed by
//     one conditional subtraction (reduce_barrett).  64 + 81 + 44 = 189
//     multiply-adds.
// fadd and fsub need only a, b < m, which holds for every field here.
//
// The header also compiles as plain host C++ (no __CUDACC__): the CPU
// tests build csrc/host_check.cpp, the kernels' per-lane bodies, with the
// host compiler and hold them against the plain PyTorch versions.
#pragma once

#include <stdint.h>

#ifndef __CUDACC__
#define __device__
#define __host__
#define __forceinline__ inline
#define __constant__
#endif

namespace dkg {

constexpr int kWords = 8;   // 32-bit words per element
constexpr int kLimbs = 16;  // 16-bit limbs per element in memory

// Field ids shared with the Python wrappers (ops/field_kernels.py).
constexpr int kSecpP = 0;  // secp256k1 base field p
constexpr int kSecpN = 1;  // secp256k1 group order n
constexpr int kEdP = 2;    // ed25519 base field 2^255 - 19
constexpr int kEdL = 3;    // ristretto255 scalar field 2^252 + delta

enum class Reduction { kFold256, kFold255, kBarrett };

// NC: words of c = 2^256 - m in use; H2: words of the value above 2^256
// after the first fold (see reduce_fold256()).
template <int F> struct Field;
template <> struct Field<kSecpP> {
  static constexpr Reduction kind = Reduction::kFold256;
  static constexpr int NC = 2, H2 = 2;
};
template <> struct Field<kSecpN> {
  static constexpr Reduction kind = Reduction::kFold256;
  static constexpr int NC = 5, H2 = 5;
};
template <> struct Field<kEdP> { static constexpr Reduction kind = Reduction::kFold255; };
template <> struct Field<kEdL> { static constexpr Reduction kind = Reduction::kBarrett; };

__constant__ uint32_t kModulus[4][kWords] = {
    {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu},
    {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
     0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu},
    {0xFFFFFFEDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu},
    {0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u, 0x14DEF9DEu,
     0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u},
};

// kFold256 fields: c = 2^256 - m, little-endian words (zero-padded to 5).
__constant__ uint32_t kFold[2][5] = {
    {0x000003D1u, 0x00000001u, 0u, 0u, 0u},
    {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u, 0x00000001u},
};

// kBarrett: mu = floor(2^512 / l), 260 bits.
__constant__ uint32_t kMuL[kWords + 1] = {
    0x0A2C131Bu, 0xED9CE5A3u, 0x086329A7u, 0x2106215Du, 0xFFFFFFEBu,
    0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x0000000Fu,
};

// Four limbs, as one 16-byte load or store (every element starts at a
// multiple of 64 bytes from a 16-byte aligned base).
struct alignas(16) Limbs4 {
  int32_t x, y, z, w;
};

__device__ __forceinline__ void load16(const int32_t* src, uint32_t w[kWords]) {
  const Limbs4* v = reinterpret_cast<const Limbs4*>(src);
#pragma unroll
  for (int k = 0; k < kWords / 2; ++k) {
    const Limbs4 q = v[k];
    w[2 * k] = (uint32_t)q.x | ((uint32_t)q.y << 16);
    w[2 * k + 1] = (uint32_t)q.z | ((uint32_t)q.w << 16);
  }
}

__device__ __forceinline__ void store16(int32_t* dst, const uint32_t w[kWords]) {
  Limbs4* v = reinterpret_cast<Limbs4*>(dst);
#pragma unroll
  for (int k = 0; k < kWords / 2; ++k) {
    v[k] = Limbs4{(int32_t)(w[2 * k] & 0xFFFFu), (int32_t)(w[2 * k] >> 16),
                  (int32_t)(w[2 * k + 1] & 0xFFFFu), (int32_t)(w[2 * k + 1] >> 16)};
  }
}

__device__ __forceinline__ void copy(uint32_t r[kWords], const uint32_t a[kWords]) {
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = a[k];
}

// r <- v[0..9) - m if that does not borrow, else v[0..8): v < 2m required.
template <int F>
__device__ __forceinline__ void cond_sub9(uint32_t r[kWords], const uint32_t v[kWords + 1]) {
  uint32_t d[kWords];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = (uint64_t)v[k] - kModulus[F][k] - borrow;
    d[k] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  uint64_t top = (uint64_t)v[kWords] - borrow;  // borrow out of the 9th word
  bool keep = (top >> 32) & 1;
#pragma unroll
  for (int k = 0; k < kWords; ++k) r[k] = keep ? v[k] : d[k];
}

// kFold256: v <- v[0..8) + v[8..8+H) * c, with v[8+H..17) == 0 on entry.
template <int F, int H>
__device__ __forceinline__ void fold(uint32_t v[17]) {
  static_assert(Field<F>::kind == Reduction::kFold256, "fold needs m = 2^256 - c");
  constexpr int NC = Field<F>::NC;
  constexpr int NP = H + NC;                 // words of hi * c
  constexpr int KMAX = NP > kWords ? NP : kWords;
  uint32_t hi[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    hi[i] = v[kWords + i];
    v[kWords + i] = 0;
  }
  uint32_t prod[NP];
#pragma unroll
  for (int k = 0; k < NP; ++k) prod[k] = 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < NC; ++j) {
      uint64_t s = (uint64_t)hi[i] * kFold[F][j] + prod[i + j] + carry;
      prod[i + j] = (uint32_t)s;
      carry = s >> 32;
    }
    prod[i + NC] = (uint32_t)carry;
  }
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < KMAX; ++k) {
    uint64_t s = (uint64_t)v[k] + (k < NP ? prod[k] : 0u) + carry;
    v[k] = (uint32_t)s;
    carry = s >> 32;
  }
  v[KMAX] = (uint32_t)carry;
}

// kFold256: r <- t mod m for a 512-bit t (t[16] must be 0).  Bounds, with
// c < 2^cb (cb = 33 for p, 129 for n):
//   fold 1: t < 2^512            -> v < 2^256 + 2^(256+cb)  (8+H2 words)
//   fold 2: hi < 2^(1+cb)        -> v < 2^256 + 2^(1+2cb) <= 2^260 (9 words)
//   fold 3: hi < 2^4             -> v < 2^256 + 2^(4+cb)
// and v - m < m whenever v >= m, so one conditional subtraction lands in
// [0, m).
template <int F>
__device__ __forceinline__ void reduce_fold256(uint32_t r[kWords], uint32_t t[17]) {
  fold<F, 8>(t);
  fold<F, Field<F>::H2>(t);
  fold<F, 1>(t);
  cond_sub9<F>(r, t);
}

// kFold255: r <- t mod (2^255 - 19) for t < 2^511 (t[16] must be 0).
//   v = lo + 38*hi < 2^256 + 38*2^255 < 2^262     (8 words and a carry)
//   v = (v mod 2^255) + 19*(v >> 255) < 2^255 + 19*2^7 < 2p
// then one conditional subtraction.
template <int F>
__device__ __forceinline__ void reduce_fold255(uint32_t r[kWords], const uint32_t t[17]) {
  uint32_t v[kWords + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = (uint64_t)t[kWords + k] * 38u + t[k] + carry;
    v[k] = (uint32_t)s;
    carry = s >> 32;
  }
  const uint32_t q = ((uint32_t)carry << 1) | (v[kWords - 1] >> 31);  // v >> 255, < 2^7
  v[kWords - 1] &= 0x7FFFFFFFu;
  carry = (uint64_t)q * 19u;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = (uint64_t)v[k] + carry;
    v[k] = (uint32_t)s;
    carry = s >> 32;
  }
  v[kWords] = (uint32_t)carry;  // 0: the sum is below 2^256
  cond_sub9<F>(r, v);
}

// kBarrett: r <- t mod l for t < l^2 (t[16] must be 0), HAC 14.42 with
// b = 2^32, k = 8: q3 = floor(floor(t / b^7) * mu / b^9).  Both floors and
// mu < 2^512 / l lose less than t / 2^512 + 2^224 / l < 2^-6 + 2^-28 of
// t / l (t < l^2 < 2^506), so q3 >= floor(t / l) - 1 (HAC's general bound
// is 2), and r = (t - q3*l) mod b^9 lies in [0, 2l): one conditional
// subtraction.
template <int F>
__device__ __forceinline__ void reduce_barrett(uint32_t r[kWords], const uint32_t t[17]) {
  constexpr int K1 = kWords + 1;  // 9 words
  uint32_t q2[2 * K1];            // (t >> 224) * mu, 81 multiply-adds
#pragma unroll
  for (int k = 0; k < 2 * K1; ++k) q2[k] = 0;
#pragma unroll
  for (int i = 0; i < K1; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < K1; ++j) {
      uint64_t s = (uint64_t)t[kWords - 1 + i] * kMuL[j] + q2[i + j] + carry;
      q2[i + j] = (uint32_t)s;
      carry = s >> 32;
    }
    q2[i + K1] = (uint32_t)carry;
  }
  // r2 = (q3 * l) mod b^9, q3 = q2[9..18): the 44 products below b^9
  uint32_t r2[K1];
#pragma unroll
  for (int k = 0; k < K1; ++k) r2[k] = 0;
#pragma unroll
  for (int i = 0; i < K1; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      if (i + j < K1) {
        uint64_t s = (uint64_t)q2[K1 + i] * kModulus[F][j] + r2[i + j] + carry;
        r2[i + j] = (uint32_t)s;
        carry = s >> 32;
      }
    }
    if (i + kWords < K1) r2[i + kWords] = (uint32_t)carry;
  }
  uint32_t v[K1];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < K1; ++k) {
    uint64_t s = (uint64_t)t[k] - r2[k] - borrow;
    v[k] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  cond_sub9<F>(r, v);  // v < 2l
}

template <int F>
__device__ __forceinline__ void reduce(uint32_t r[kWords], uint32_t t[17]) {
  if constexpr (Field<F>::kind == Reduction::kFold256) {
    reduce_fold256<F>(r, t);
  } else if constexpr (Field<F>::kind == Reduction::kFold255) {
    reduce_fold255<F>(r, t);
  } else {
    reduce_barrett<F>(r, t);
  }
}

// t[0..16) <- a * b (schoolbook, 64 multiply-adds); t[16] <- 0.
__device__ __forceinline__ void mul_wide(uint32_t t[17], const uint32_t a[kWords],
                                         const uint32_t b[kWords]) {
#pragma unroll
  for (int k = 0; k < 17; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < kWords; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < kWords; ++j) {
      uint64_t s = (uint64_t)a[i] * b[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)s;
      carry = s >> 32;
    }
    t[i + kWords] = (uint32_t)carry;
  }
}

template <int F>
__device__ __forceinline__ void fmul(uint32_t r[kWords], const uint32_t a[kWords],
                                     const uint32_t b[kWords]) {
  uint32_t t[17];
  mul_wide(t, a, b);
  reduce<F>(r, t);
}

// r <- (a * b + c) mod m: a*b + c < m^2 < 2^512, so one reduction.
template <int F>
__device__ __forceinline__ void fmadd(uint32_t r[kWords], const uint32_t a[kWords],
                                      const uint32_t b[kWords], const uint32_t c[kWords]) {
  uint32_t t[17];
  mul_wide(t, a, b);
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 16; ++k) {
    uint64_t s = (uint64_t)t[k] + (k < kWords ? c[k] : 0u) + carry;
    t[k] = (uint32_t)s;
    carry = s >> 32;
  }
  reduce<F>(r, t);
}

// kFold256 only: r <- (a * s) mod m for a small constant s < 2^32 (one
// fold suffices to get below 2^256 + 2^(32+cb); the second is a cheap
// no-op).
template <int F>
__device__ __forceinline__ void fmul_small(uint32_t r[kWords], const uint32_t a[kWords],
                                           uint32_t s) {
  uint32_t t[17];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t v = (uint64_t)a[k] * s + carry;
    t[k] = (uint32_t)v;
    carry = v >> 32;
  }
  t[kWords] = (uint32_t)carry;
#pragma unroll
  for (int k = kWords + 1; k < 17; ++k) t[k] = 0;
  fold<F, 1>(t);
  fold<F, 1>(t);
  cond_sub9<F>(r, t);
}

template <int F>
__device__ __forceinline__ void fadd(uint32_t r[kWords], const uint32_t a[kWords],
                                     const uint32_t b[kWords]) {
  uint32_t v[kWords + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = (uint64_t)a[k] + b[k] + carry;
    v[k] = (uint32_t)s;
    carry = s >> 32;
  }
  v[kWords] = (uint32_t)carry;
  cond_sub9<F>(r, v);  // a + b < 2m
}

template <int F>
__device__ __forceinline__ void fsub(uint32_t r[kWords], const uint32_t a[kWords],
                                     const uint32_t b[kWords]) {
  uint32_t d[kWords];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  // a < b: add m back (the sum wraps past 2^256 exactly once)
  uint32_t mask = 0u - (uint32_t)borrow;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) {
    uint64_t s = (uint64_t)d[k] + (kModulus[F][k] & mask) + carry;
    r[k] = (uint32_t)s;
    carry = s >> 32;
  }
}

__device__ __forceinline__ bool is_zero(const uint32_t a[kWords]) {
  uint32_t acc = 0;
#pragma unroll
  for (int k = 0; k < kWords; ++k) acc |= a[k];
  return acc == 0;
}

}  // namespace dkg
