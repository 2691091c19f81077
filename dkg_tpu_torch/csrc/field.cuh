// Modular arithmetic for the six fields of the ported curves, one field
// element per thread, shared by every kernel in this directory:
// secp256k1's base field p and group order n, ed25519's base field
// p = 2^255 - 19, the ristretto255 scalar field l = 2^252 + delta, and
// BLS12-381's base field p (381 bits) and scalar field r (255 bits).
//
// Storage format (the port's tensors, the JAX package's layout): 2N
// little-endian 16-bit limbs, one per int32 word (L = 16 limbs for the
// 256-bit fields, 24 for BLS12-381 p).  Inside a kernel an element is N
// little-endian 32-bit words, N = Field<F>::N (8, or 12 for BLS12-381
// p): load_elem/store_elem convert at the edges, and every op in between
// returns the canonical residue in [0, m), so the stored limbs equal the
// JAX package's limb for limb.
//
// A field is a template parameter F (the ids below, shared with
// ops/field_kernels.py); Field<F> names its word count and reduction,
// and the modulus words sit in __constant__ kModulus[F].  The three
// reductions of a 2N-word product t = hi*2^(32N) + lo:
//   kFold256 (secp256k1 p and n, m = 2^256 - c with a short c: 33 bits
//     for p, 129 for n): three folds lo + hi*c bring t below
//     2^256 + 2^(4+cb), then one conditional subtraction (reduce_fold256).
//     64 + 22 = 86 multiply-adds for p, 64 + 70 = 134 for n.
//   kFold255 (ed25519 p): 2^256 = 38 and 2^255 = 19 mod p.  One fold
//     lo + 38*hi leaves up to 263 bits, one fold at bit 255 (q*19) brings
//     it below 2^255 + 2^12 < 2p, then one conditional subtraction
//     (reduce_fold255).  64 + 8 + 1 = 73 multiply-adds.
//   kBarrett (ristretto255 l, BLS12-381 p and r): no short 2^(32N) - c
//     form (2^256 mod l is about 2^252, 2^256 mod r about 2^252.6, and
//     BLS12-381 p has none), so HAC 14.42 with b = 2^32, k = N and
//     mu = floor(2^(64N) / m), N + 1 words (the plain version's
//     FieldSpec.barrett_mu): one conditional subtraction, by the bound at
//     reduce_barrett.  N^2 + (N+1)^2 + N(N+3)/2 multiply-adds (schoolbook,
//     quotient, quotient times m): 64 + 81 + 44 = 189 for l and r,
//     144 + 169 + 90 = 403 for BLS12-381 p.
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
#define __noinline__ __attribute__((noinline))
#endif

namespace dkg {

constexpr int kMaxWords = 12;  // 32-bit words of the widest element

// Field ids shared with the Python wrappers (ops/field_kernels.py).
constexpr int kSecpP = 0;  // secp256k1 base field p
constexpr int kSecpN = 1;  // secp256k1 group order n
constexpr int kEdP = 2;    // ed25519 base field 2^255 - 19
constexpr int kEdL = 3;    // ristretto255 scalar field 2^252 + delta
constexpr int kBlsP = 4;   // BLS12-381 base field p, 381 bits
constexpr int kBlsR = 5;   // BLS12-381 scalar field r, 255 bits

enum class Reduction { kFold256, kFold255, kBarrett };

// N: 32-bit words of an element.  kFold256: NC words of c = 2^256 - m in
// use, H2 words of the value above 2^256 after the first fold (see
// reduce_fold256()).  kBarrett: MU, the row of kMu.
template <int F> struct Field;
template <> struct Field<kSecpP> {
  static constexpr Reduction kind = Reduction::kFold256;
  static constexpr int N = 8, NC = 2, H2 = 2;
};
template <> struct Field<kSecpN> {
  static constexpr Reduction kind = Reduction::kFold256;
  static constexpr int N = 8, NC = 5, H2 = 5;
};
template <> struct Field<kEdP> {
  static constexpr Reduction kind = Reduction::kFold255;
  static constexpr int N = 8;
};
template <> struct Field<kEdL> {
  static constexpr Reduction kind = Reduction::kBarrett;
  static constexpr int N = 8, MU = 0;
};
template <> struct Field<kBlsP> {
  static constexpr Reduction kind = Reduction::kBarrett;
  static constexpr int N = 12, MU = 1;
};
template <> struct Field<kBlsR> {
  static constexpr Reduction kind = Reduction::kBarrett;
  static constexpr int N = 8, MU = 2;
};

// Little-endian words, zero-padded to kMaxWords.
__constant__ uint32_t kModulus[6][kMaxWords] = {
    {0xFFFFFC2Fu, 0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu},
    {0xD0364141u, 0xBFD25E8Cu, 0xAF48A03Bu, 0xBAAEDCE6u,
     0xFFFFFFFEu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu},
    {0xFFFFFFEDu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x7FFFFFFFu},
    {0x5CF5D3EDu, 0x5812631Au, 0xA2F79CD6u, 0x14DEF9DEu,
     0x00000000u, 0x00000000u, 0x00000000u, 0x10000000u},
    {0xFFFFAAABu, 0xB9FEFFFFu, 0xB153FFFFu, 0x1EABFFFEu,
     0xF6B0F624u, 0x6730D2A0u, 0xF38512BFu, 0x64774B84u,
     0x434BACD7u, 0x4B1BA7B6u, 0x397FE69Au, 0x1A0111EAu},
    {0x00000001u, 0xFFFFFFFFu, 0xFFFE5BFEu, 0x53BDA402u,
     0x09A1D805u, 0x3339D808u, 0x299D7D48u, 0x73EDA753u},
};

// kFold256 fields: c = 2^256 - m, little-endian words (zero-padded to 5).
__constant__ uint32_t kFold[2][5] = {
    {0x000003D1u, 0x00000001u, 0u, 0u, 0u},
    {0x2FC9BEBFu, 0x402DA173u, 0x50B75FC4u, 0x45512319u, 0x00000001u},
};

// kBarrett: mu = floor(2^(64N) / m), N + 1 words (zero-padded to 13):
// l (260 bits), BLS12-381 p (388 bits), BLS12-381 r (258 bits).
__constant__ uint32_t kMu[3][kMaxWords + 1] = {
    {0x0A2C131Bu, 0xED9CE5A3u, 0x086329A7u, 0x2106215Du, 0xFFFFFFEBu,
     0xFFFFFFFFu, 0xFFFFFFFFu, 0xFFFFFFFFu, 0x0000000Fu},
    {0x6591BA2Eu, 0x13E207F5u, 0x58F1C07Bu, 0x997167A0u, 0x286779D3u,
     0xDF4771E0u, 0xF6A0A94Bu, 0x1B82741Fu, 0xC7A6BA29u, 0x28101B0Cu,
     0xCC9E45CEu, 0xD835D2F3u, 0x00000009u},
    {0x0C0D6393u, 0x42737A02u, 0xBE4BAD71u, 0x65043EB4u, 0x07E08ED3u,
     0x38B5DCB7u, 0xFEDE377Cu, 0x355094EDu, 0x00000002u},
};

// Four limbs, as one 16-byte load or store (every element starts at a
// multiple of 8N bytes, 64 or 96, from a 16-byte aligned base).
struct alignas(16) Limbs4 {
  int32_t x, y, z, w;
};

// w <- the N-word value of the 2N stored limbs at src.
template <int N>
__device__ __forceinline__ void load_elem(const int32_t* src, uint32_t w[N]) {
  const Limbs4* v = reinterpret_cast<const Limbs4*>(src);
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    const Limbs4 q = v[k];
    w[2 * k] = (uint32_t)q.x | ((uint32_t)q.y << 16);
    w[2 * k + 1] = (uint32_t)q.z | ((uint32_t)q.w << 16);
  }
}

template <int N>
__device__ __forceinline__ void store_elem(int32_t* dst, const uint32_t w[N]) {
  Limbs4* v = reinterpret_cast<Limbs4*>(dst);
#pragma unroll
  for (int k = 0; k < N / 2; ++k) {
    v[k] = Limbs4{(int32_t)(w[2 * k] & 0xFFFFu), (int32_t)(w[2 * k] >> 16),
                  (int32_t)(w[2 * k + 1] & 0xFFFFu), (int32_t)(w[2 * k + 1] >> 16)};
  }
}

template <int N>
__device__ __forceinline__ void copy(uint32_t r[N], const uint32_t a[N]) {
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = a[k];
}

// r <- v[0..N+1) - m if that does not borrow, else v[0..N): v < 2m required.
template <int F>
__device__ __forceinline__ void cond_sub(uint32_t r[], const uint32_t v[]) {
  constexpr int N = Field<F>::N;
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t s = (uint64_t)v[k] - kModulus[F][k] - borrow;
    d[k] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  uint64_t top = (uint64_t)v[N] - borrow;  // borrow out of the top word
  bool keep = (top >> 32) & 1;
#pragma unroll
  for (int k = 0; k < N; ++k) r[k] = keep ? v[k] : d[k];
}

// kFold256: v <- v[0..8) + v[8..8+H) * c, with v[8+H..17) == 0 on entry.
template <int F, int H>
__device__ __forceinline__ void fold(uint32_t v[17]) {
  static_assert(Field<F>::kind == Reduction::kFold256, "fold needs m = 2^256 - c");
  constexpr int W = Field<F>::N;             // 8
  constexpr int NC = Field<F>::NC;
  constexpr int NP = H + NC;                 // words of hi * c
  constexpr int KMAX = NP > W ? NP : W;
  uint32_t hi[H];
#pragma unroll
  for (int i = 0; i < H; ++i) {
    hi[i] = v[W + i];
    v[W + i] = 0;
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
__device__ __forceinline__ void reduce_fold256(uint32_t r[], uint32_t t[17]) {
  fold<F, 8>(t);
  fold<F, Field<F>::H2>(t);
  fold<F, 1>(t);
  cond_sub<F>(r, t);
}

// kFold255: r <- t mod (2^255 - 19) for t < 2^511 (t[16] must be 0).
//   v = lo + 38*hi < 2^256 + 38*2^255 < 2^262     (8 words and a carry)
//   v = (v mod 2^255) + 19*(v >> 255) < 2^255 + 19*2^7 < 2p
// then one conditional subtraction.
template <int F>
__device__ __forceinline__ void reduce_fold255(uint32_t r[], const uint32_t t[17]) {
  constexpr int W = Field<F>::N;  // 8
  uint32_t v[W + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t s = (uint64_t)t[W + k] * 38u + t[k] + carry;
    v[k] = (uint32_t)s;
    carry = s >> 32;
  }
  const uint32_t q = ((uint32_t)carry << 1) | (v[W - 1] >> 31);  // v >> 255, < 2^7
  v[W - 1] &= 0x7FFFFFFFu;
  carry = (uint64_t)q * 19u;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t s = (uint64_t)v[k] + carry;
    v[k] = (uint32_t)s;
    carry = s >> 32;
  }
  v[W] = (uint32_t)carry;  // 0: the sum is below 2^256
  cond_sub<F>(r, v);
}

// kBarrett: r <- t mod m for t < m^2 (t[2N] must be 0), HAC 14.42 with
// b = 2^32, k = N: q1 = floor(t / b^(N-1)), q3 = floor(q1 * mu / b^(N+1)).
// With mu = b^(2N)/m - e1 and q1 = t/b^(N-1) - e2 (e1, e2 in [0, 1)),
//   t/m - q1*mu/b^(N+1) < b^(N-1)/m + t/b^(2N) < b^(N-1)/m + m^2/b^(2N),
// which is below 1 for every Barrett field here: 2^224/l + l^2/2^512
// < 0.004, 2^224/r + r^2/2^512 < 0.21, 2^352/p + p^2/2^768 < 0.011
// (BLS12-381 p).  So q3 >= floor(t/m) - 1 (HAC's general bound is 2),
// r = (t - q3*m) mod b^(N+1) lies in [0, 2m) with 2m < b^N, and one
// conditional subtraction lands in [0, m).  Multiply-adds: (N+1)^2 for
// q1*mu, and for q3*m mod b^(N+1) the N + N(N+1)/2 products below
// b^(N+1): 81 + 44 at N = 8, 169 + 90 at N = 12.
template <int F>
__device__ __forceinline__ void reduce_barrett(uint32_t r[], const uint32_t t[]) {
  constexpr int N = Field<F>::N;
  constexpr int K1 = N + 1;
  constexpr int MU = Field<F>::MU;
  uint32_t q2[2 * K1];  // q1 * mu
#pragma unroll
  for (int k = 0; k < 2 * K1; ++k) q2[k] = 0;
#pragma unroll
  for (int i = 0; i < K1; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < K1; ++j) {
      uint64_t s = (uint64_t)t[N - 1 + i] * kMu[MU][j] + q2[i + j] + carry;
      q2[i + j] = (uint32_t)s;
      carry = s >> 32;
    }
    q2[i + K1] = (uint32_t)carry;
  }
  // r2 = (q3 * m) mod b^(N+1), q3 = q2[N+1..2N+2): the products below b^(N+1)
  uint32_t r2[K1];
#pragma unroll
  for (int k = 0; k < K1; ++k) r2[k] = 0;
#pragma unroll
  for (int i = 0; i < K1; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      if (i + j < K1) {
        uint64_t s = (uint64_t)q2[K1 + i] * kModulus[F][j] + r2[i + j] + carry;
        r2[i + j] = (uint32_t)s;
        carry = s >> 32;
      }
    }
    if (i + N < K1) r2[i + N] = (uint32_t)carry;
  }
  uint32_t v[K1];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < K1; ++k) {
    uint64_t s = (uint64_t)t[k] - r2[k] - borrow;
    v[k] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  cond_sub<F>(r, v);  // v < 2m
}

template <int F>
__device__ __forceinline__ void reduce(uint32_t r[], uint32_t t[]) {
  if constexpr (Field<F>::kind == Reduction::kFold256) {
    reduce_fold256<F>(r, t);
  } else if constexpr (Field<F>::kind == Reduction::kFold255) {
    reduce_fold255<F>(r, t);
  } else {
    reduce_barrett<F>(r, t);
  }
}

// t[0..2N) <- a * b (schoolbook, N^2 multiply-adds); t[2N] <- 0.
template <int N>
__device__ __forceinline__ void mul_wide(uint32_t t[2 * N + 1], const uint32_t a[N],
                                         const uint32_t b[N]) {
#pragma unroll
  for (int k = 0; k < 2 * N + 1; ++k) t[k] = 0;
#pragma unroll
  for (int i = 0; i < N; ++i) {
    uint64_t carry = 0;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      uint64_t s = (uint64_t)a[i] * b[j] + t[i + j] + carry;
      t[i + j] = (uint32_t)s;
      carry = s >> 32;
    }
    t[i + N] = (uint32_t)carry;
  }
}

template <int F>
__device__ __forceinline__ void fmul_inline(uint32_t r[], const uint32_t a[], const uint32_t b[]) {
  constexpr int N = Field<F>::N;
  uint32_t t[2 * N + 1];
  mul_wide<N>(t, a, b);
  reduce<F>(r, t);
}

// An element by value: an out-of-line multiply takes and returns it in
// registers, where a pointer to a thread's array would put the array in
// local memory.
template <int N>
struct Elem {
  uint32_t w[N];
};

template <int F>
__device__ __noinline__ Elem<Field<F>::N> fmul_call(const Elem<Field<F>::N> a,
                                                    const Elem<Field<F>::N> b) {
  Elem<Field<F>::N> r;
  fmul_inline<F>(r.w, a.w, b.w);
  return r;
}

// Fields whose multiply is compiled once a kernel and called: BLS12-381 p.
// Its 403 multiply-adds, inlined at each of a point formula's 8 to 12
// multiplies, crashed nvcc 12.9's cicc (a segfault) on the doubling,
// window-step and bucket kernels and made the others slow to build and
// spill; one called copy keeps a kernel small, its registers at the
// multiply's own live set plus the caller's points.
template <int F>
constexpr bool kOutlineMul = false;
template <>
constexpr bool kOutlineMul<kBlsP> = true;

template <int F>
__device__ __forceinline__ void fmul(uint32_t r[], const uint32_t a[], const uint32_t b[]) {
  constexpr int N = Field<F>::N;
  if constexpr (kOutlineMul<F>) {
    Elem<N> x, y;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      x.w[k] = a[k];
      y.w[k] = b[k];
    }
    const Elem<N> z = fmul_call<F>(x, y);
#pragma unroll
    for (int k = 0; k < N; ++k) r[k] = z.w[k];
  } else {
    fmul_inline<F>(r, a, b);
  }
}

// r <- (a * b + c) mod m: a*b + c < m^2 < b^(2N), so one reduction.
template <int F>
__device__ __forceinline__ void fmadd(uint32_t r[], const uint32_t a[], const uint32_t b[],
                                      const uint32_t c[]) {
  constexpr int N = Field<F>::N;
  uint32_t t[2 * N + 1];
  mul_wide<N>(t, a, b);
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < 2 * N; ++k) {
    uint64_t s = (uint64_t)t[k] + (k < N ? c[k] : 0u) + carry;
    t[k] = (uint32_t)s;
    carry = s >> 32;
  }
  reduce<F>(r, t);
}

// kFold256 only: r <- (a * s) mod m for a small constant s < 2^32 (one
// fold suffices to get below 2^256 + 2^(32+cb); the second is a cheap
// no-op).
template <int F>
__device__ __forceinline__ void fmul_small(uint32_t r[], const uint32_t a[], uint32_t s) {
  constexpr int W = Field<F>::N;  // 8
  uint32_t t[17];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < W; ++k) {
    uint64_t v = (uint64_t)a[k] * s + carry;
    t[k] = (uint32_t)v;
    carry = v >> 32;
  }
  t[W] = (uint32_t)carry;
#pragma unroll
  for (int k = W + 1; k < 17; ++k) t[k] = 0;
  fold<F, 1>(t);
  fold<F, 1>(t);
  cond_sub<F>(r, t);
}

template <int F>
__device__ __forceinline__ void fadd(uint32_t r[], const uint32_t a[], const uint32_t b[]) {
  constexpr int N = Field<F>::N;
  uint32_t v[N + 1];
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t s = (uint64_t)a[k] + b[k] + carry;
    v[k] = (uint32_t)s;
    carry = s >> 32;
  }
  v[N] = (uint32_t)carry;
  cond_sub<F>(r, v);  // a + b < 2m
}

template <int F>
__device__ __forceinline__ void fsub(uint32_t r[], const uint32_t a[], const uint32_t b[]) {
  constexpr int N = Field<F>::N;
  uint32_t d[N];
  uint64_t borrow = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t s = (uint64_t)a[k] - b[k] - borrow;
    d[k] = (uint32_t)s;
    borrow = (s >> 32) & 1;
  }
  // a < b: add m back (the sum wraps past 2^(32N) exactly once)
  uint32_t mask = 0u - (uint32_t)borrow;
  uint64_t carry = 0;
#pragma unroll
  for (int k = 0; k < N; ++k) {
    uint64_t s = (uint64_t)d[k] + (kModulus[F][k] & mask) + carry;
    r[k] = (uint32_t)s;
    carry = s >> 32;
  }
}

}  // namespace dkg
