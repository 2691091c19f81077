// Modular arithmetic for the secp256k1 base and scalar fields, one field
// element per thread, shared by every kernel in this directory.
//
// Storage format (the port's tensors, the JAX package's layout): 16
// little-endian 16-bit limbs, one per int32 word.  Inside a kernel an
// element is 8 little-endian 32-bit words: load16/store16 convert at the
// edges, and every op in between returns the canonical residue in [0, m),
// so the stored limbs equal the JAX package's limb for limb.
//
// Reduction: both moduli are m = 2^256 - c with a short c (secp256k1's p:
// c = 2^32 + 977, 33 bits; its group order n: c has 129 bits), so a
// 512-bit value hi*2^256 + lo reduces by folds lo + hi*c.  Three folds
// bring any product below 2^256 + 2^133 (bounds per fold in reduce()),
// and one conditional subtraction finishes.  Products are 32x32->64-bit
// multiply-adds: 64 for the schoolbook, plus 8*NC + H2*NC + NC for the
// folds (NC = words of c): 86 for p, 134 for n.
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
constexpr int kBase = 0;    // secp256k1 base field p
constexpr int kScalar = 1;  // secp256k1 group order n

__constant__ uint32_t kModulus[2][kWords] = {
    {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu},
    {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
     0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu},
};

// c = 2^256 - m, little-endian words (zero-padded to 5).
__constant__ uint32_t kFold[2][5] = {
    {0x000003D1u, 0x00000001u, 0u, 0u, 0u},
    {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u, 0x00000001u},
};

// Words of c in use, and the words of the value above 2^256 after the
// first fold (see reduce()).
template <int F> struct FieldShape;
template <> struct FieldShape<kBase> { static constexpr int NC = 2, H2 = 2; };
template <> struct FieldShape<kScalar> { static constexpr int NC = 5, H2 = 5; };

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

// v <- v[0..8) + v[8..8+H) * c, with v[8+H..17) == 0 on entry.
template <int F, int H>
__device__ __forceinline__ void fold(uint32_t v[17]) {
  constexpr int NC = FieldShape<F>::NC;
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

// r <- t mod m for a 512-bit t (t[16] must be 0).  Bounds, with c < 2^cb
// (cb = 33 for p, 129 for n):
//   fold 1: t < 2^512            -> v < 2^256 + 2^(256+cb)  (8+H2 words)
//   fold 2: hi < 2^(1+cb)        -> v < 2^256 + 2^(1+2cb) <= 2^260 (9 words)
//   fold 3: hi < 2^4             -> v < 2^256 + 2^(4+cb)
// and v - m < m whenever v >= m, so one conditional subtraction lands in
// [0, m).
template <int F>
__device__ __forceinline__ void reduce(uint32_t r[kWords], uint32_t t[17]) {
  fold<F, 8>(t);
  fold<F, FieldShape<F>::H2>(t);
  fold<F, 1>(t);
  cond_sub9<F>(r, t);
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

// r <- (a * s) mod m for a small constant s < 2^32 (one fold suffices to
// get below 2^256 + 2^(32+cb); the remaining folds are cheap no-ops).
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
