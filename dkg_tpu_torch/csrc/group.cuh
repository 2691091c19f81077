// A field element spread over a group of TPI threads of one warp, and the
// point formulas of the three curves over it: the core of the one-launch
// point Horner kernel (ladder_kernels.cu).
//
// Rank r of a group holds words [r S, r S + S) of each element, S = N / TPI
// (N = Field<F>::N words).  Inside a kernel an element is in Montgomery
// form a R mod p, R = 2^(32N), canonical in [0, p); load converts stored
// limbs in (one Montgomery multiply by R^2 mod p) and store converts out
// (one by 1), so the limbs at the kernel's edges are the canonical
// residues the one-thread kernels of point.cuh and edwards.cuh store.
// Every op below is exact modular arithmetic on canonical values, so the
// same formulas in the same order give the same projective coordinates
// limb for limb (the representation inside is free; the order is not).
//
// The multiply is CIOS Montgomery (Koc, Acar, Kaliski 1996) with the word
// loop spread over the group: at step i every rank multiplies its slice
// of a by word i of b (a shuffle from the rank that holds it), rank 0
// computes the quotient word m (a shuffle to all), every rank adds m times
// its slice of p, and the value moves down one word (rank r + 1's lowest
// word becomes rank r's highest, a shuffle).  Carries out of a slice are
// not propagated at each step: each rank keeps the carry out of its top
// word, which the shift lands on its own top word at the next step, so a
// step costs 2S multiply-adds and three shuffles a rank; after the N steps
// one carry chain across the ranks (two ballots) settles the value below
// 2p and one conditional subtraction (two more) makes it canonical.  A
// multiply is 2N^2 + N multiply-adds over the group (136 at N = 8, 300 at
// N = 12, against 86 for secp256k1 p's fold and 403 for BLS12-381 p's
// Barrett in field.cuh), 2N^2/TPI + N/TPI a rank.
//
// Adds and subtracts carry across the ranks by lookahead: each rank says
// whether its slice generates a carry or passes one through, and the
// group's two ballots, added as integers, give every rank its carry-in at
// once (GField::chains()).
//
// A lane's work is a chain of these collective steps, so each op takes K
// independent operands (mul_k, add_k, sub_k) and runs their steps in
// lockstep: the point formulas below batch the products and sums that
// do not depend on each other, and K shuffles or ballots wait as one.
//
// The header also compiles as plain host C++ (no __CUDACC__): there the
// group is a set of host threads that meet at a barrier for each shuffle
// or ballot (csrc/host_check.cpp), and the CPU tests hold the bodies below
// against the plain PyTorch versions.
#pragma once

#include "edwards.cuh"
#include "point.cuh"

namespace dkg {

// Montgomery constants of the base fields with a group variant, rows in
// the order secp256k1 p, ed25519 p, BLS12-381 p: n0' = -p^-1 mod 2^32,
// R^2 mod p and R mod p (the Montgomery form of 1), little-endian words.
template <int F>
struct Mont;
template <>
struct Mont<kSecpP> {
  static constexpr int row = 0;
};
template <>
struct Mont<kEdP> {
  static constexpr int row = 1;
};
template <>
struct Mont<kBlsP> {
  static constexpr int row = 2;
};

__constant__ uint32_t kMontN0[3] = {0xD2253531u, 0x286BCA1Bu, 0xFFFCFFFDu};
__constant__ uint32_t kMontR2[3][kMaxWords] = {
    {0x000E90A1u, 0x000007A2u, 0x00000001u, 0u, 0u, 0u, 0u, 0u},
    {0x000005A4u, 0u, 0u, 0u, 0u, 0u, 0u, 0u},
    {0x1C341746u, 0xF4DF1F34u, 0x09D104F1u, 0x0A76E6A6u, 0x4C95B6D5u, 0x8DE5476Cu,
     0x939D83C0u, 0x67EB88A9u, 0xB519952Du, 0x9A793E85u, 0x92CAE3AAu, 0x11988FE5u},
};
__constant__ uint32_t kMontOne[3][kMaxWords] = {
    {0x000003D1u, 0x00000001u, 0u, 0u, 0u, 0u, 0u, 0u},
    {0x00000026u, 0u, 0u, 0u, 0u, 0u, 0u, 0u},
    {0x0002FFFDu, 0x76090000u, 0xC40C0002u, 0xEBF4000Bu, 0x53C758BAu, 0x5F489857u,
     0x70525745u, 0x77CE5853u, 0xA256EC6Du, 0x5C071A97u, 0xFA80E493u, 0x15F65EC3u},
};
// Curve constants in Montgomery form: secp256k1's b3 = 21 (21 R mod p) and
// edwards25519's 2d (2d R mod p).
__constant__ uint32_t kMontB3Secp[8] = {0x00005025u, 0x00000015u, 0u, 0u, 0u, 0u, 0u, 0u};
__constant__ uint32_t kMontEd2D[8] = {0xBE8FD3F4u, 0x01DB17FDu, 0x5F8C52E7u, 0x21430EEFu,
                                      0x78310D20u, 0xCB27240Fu, 0xE53F8A4Du, 0x590456B4u};

#ifdef __CUDACC__
// TPI consecutive lanes of a warp.  Every call is made by the whole warp
// at once (the code that calls them is warp-uniform: see
// ladder_horner_lane), so each takes the full-warp mask: with a mask
// naming only the group, nvcc wraps each shuffle and ballot in a
// convergence sequence (WARPSYNC, BSSY/BSYNC, a vote) several times its
// own length.
template <int TPI>
struct WarpGroup {
  static constexpr int kTpi = TPI;
  static constexpr uint32_t kAll = 0xFFFFFFFFu;
  uint32_t rank, base;
  __device__ explicit WarpGroup(uint32_t tid) {
    const uint32_t lane = tid & 31u;
    rank = lane % TPI;
    base = lane - rank;
  }
  // rank src's v
  __device__ __forceinline__ uint32_t shfl(uint32_t v, int src) const {
    return __shfl_sync(kAll, v, src, TPI);
  }
  // rank + 1's v (the top rank gets its own)
  __device__ __forceinline__ uint32_t next(uint32_t v) const {
    return __shfl_down_sync(kAll, v, 1, TPI);
  }
  // rank - 1's v (rank 0 gets its own)
  __device__ __forceinline__ uint32_t prev(uint32_t v) const {
    return __shfl_up_sync(kAll, v, 1, TPI);
  }
  // bit r: rank r's p
  __device__ __forceinline__ uint32_t ballot(bool p) const {
    return (__ballot_sync(kAll, p) >> base) & ((1u << TPI) - 1u);
  }
  // whether p holds anywhere in the warp: the warp-uniform decisions
  __device__ __forceinline__ bool any(bool p) const { return __any_sync(kAll, p); }
};
#endif

// S-word slices: r <- a + b (returns the carry out), r <- a - b (the
// borrow out), r <- r + c and r <- r - c for a small c (carry, borrow).
template <int S>
__device__ __forceinline__ uint32_t add_words(uint32_t r[], const uint32_t a[], const uint32_t b[]) {
  uint64_t c = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const uint64_t s = (uint64_t)a[j] + b[j] + c;
    r[j] = (uint32_t)s;
    c = s >> 32;
  }
  return (uint32_t)c;
}

template <int S>
__device__ __forceinline__ uint32_t sub_words(uint32_t r[], const uint32_t a[], const uint32_t b[]) {
  uint64_t borrow = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const uint64_t s = (uint64_t)a[j] - b[j] - borrow;
    r[j] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
  return (uint32_t)borrow;
}

template <int S>
__device__ __forceinline__ uint32_t inc_words(uint32_t r[], uint32_t c) {
  uint64_t s = c;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    s += r[j];
    r[j] = (uint32_t)s;
    s >>= 32;
  }
  return (uint32_t)s;
}

template <int S>
__device__ __forceinline__ void dec_words(uint32_t r[], uint32_t c) {
  uint64_t borrow = c;
#pragma unroll
  for (int j = 0; j < S; ++j) {
    const uint64_t s = (uint64_t)r[j] - borrow;
    r[j] = (uint32_t)s;
    borrow = (s >> 32) & 1u;
  }
}

template <int S>
__device__ __forceinline__ bool all_ones(const uint32_t a[]) {
  uint32_t v = 0xFFFFFFFFu;
#pragma unroll
  for (int j = 0; j < S; ++j) v &= a[j];
  return v == 0xFFFFFFFFu;
}

template <int S>
__device__ __forceinline__ bool all_zero(const uint32_t a[]) {
  uint32_t v = 0;
#pragma unroll
  for (int j = 0; j < S; ++j) v |= a[j];
  return v == 0;
}

// The field F's arithmetic over a group G: each rank's slice of p in
// registers, and the ops on S-word slices of canonical Montgomery forms.
template <int F, class G>
struct GField {
  static constexpr int N = Field<F>::N, TPI = G::kTpi, S = N / TPI;
  static_assert(N % TPI == 0, "a group's ranks hold equal slices of an element");
  static constexpr int kRow = Mont<F>::row;
  G g;
  uint32_t p[S];

  __device__ explicit GField(const G& grp) : g(grp) {
#pragma unroll
    for (int j = 0; j < S; ++j) p[j] = kModulus[F][g.rank * S + j];
  }

  // r <- this rank's slice of the N-word constant at words
  __device__ __forceinline__ void slice(uint32_t r[], const uint32_t* words) const {
#pragma unroll
    for (int j = 0; j < S; ++j) r[j] = words[g.rank * S + j];
  }

  // r_k <- v_k + top_k 2^(32N) reduced once: v_k - p where that is >= 0,
  // else v_k.  Needs v_k + top_k 2^(32N) < 2p, top_k the same on every
  // rank.  K independent values in lockstep, so that their ballots and
  // shuffles overlap (here and in every batched op below).
  template <int K>
  __device__ __forceinline__ void reduce_once(uint32_t (&r)[K][S], const uint32_t (&v)[K][S],
                                              const bool (&top)[K]) const {
    uint32_t d[K][S];
    bool gen[K], prop[K], below[K], bin[K];  // below: v_k < p (a borrow out of the top rank)
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gen[k] = sub_words<S>(d[k], v[k], p) != 0;
      prop[k] = all_zero<S>(d[k]);
    }
    chains<K>(gen, prop, bin, below);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dec_words<S>(d[k], bin[k]);
      const uint32_t take = 0u - (uint32_t)(top[k] || !below[k]);
#pragma unroll
      for (int j = 0; j < S; ++j) r[k][j] = (d[k][j] & take) | (v[k][j] & ~take);
    }
  }

  // in_k <- the carry (or borrow) into this rank's slice of value k, when
  // each slice says whether it generates one with none coming in (gen_k)
  // or passes one coming in through (prop_k, never with gen_k); out_k <-
  // the one out of the top rank, the same on every rank.  These are the
  // carries of the binary sum (G | P) + G of the group's two ballots, bit
  // r for rank r; K values in lockstep.
  template <int K>
  __device__ __forceinline__ void chains(const bool (&gen)[K], const bool (&prop)[K], bool (&in)[K],
                                         bool (&out)[K]) const {
    uint32_t gm[K], pm[K];
#pragma unroll
    for (int k = 0; k < K; ++k) gm[k] = g.ballot(gen[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) pm[k] = g.ballot(prop[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      const uint32_t sum = (gm[k] | pm[k]) + gm[k];
      out[k] = (sum >> TPI) & 1u;
      in[k] = ((sum ^ pm[k]) >> g.rank) & 1u;
    }
  }

  // r_k <- a_k + b_k for K independent sums (r_k may alias a_k or b_k)
  template <int K>
  __device__ __forceinline__ void add_k(uint32_t* const (&r)[K], const uint32_t* const (&a)[K],
                                        const uint32_t* const (&b)[K]) const {
    uint32_t s[K][S], o[K][S];
    bool gen[K], prop[K], cin[K], top[K];
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gen[k] = add_words<S>(s[k], a[k], b[k]) != 0;
      prop[k] = all_ones<S>(s[k]);
    }
    chains<K>(gen, prop, cin, top);
#pragma unroll
    for (int k = 0; k < K; ++k) inc_words<S>(s[k], cin[k]);
    reduce_once<K>(o, s, top);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < S; ++j) r[k][j] = o[k][j];
  }

  // r_k <- a_k - b_k for K independent differences
  template <int K>
  __device__ __forceinline__ void sub_k(uint32_t* const (&r)[K], const uint32_t* const (&a)[K],
                                        const uint32_t* const (&b)[K]) const {
    uint32_t d[K][S];
    bool gen[K], prop[K], bin[K], below[K];  // below: a_k < b_k, so p is added back
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gen[k] = sub_words<S>(d[k], a[k], b[k]) != 0;
      prop[k] = all_zero<S>(d[k]);
    }
    chains<K>(gen, prop, bin, below);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      dec_words<S>(d[k], bin[k]);
      const uint32_t mk = 0u - (uint32_t)below[k];
      uint32_t q[S];
#pragma unroll
      for (int j = 0; j < S; ++j) q[j] = p[j] & mk;
      gen[k] = add_words<S>(d[k], d[k], q) != 0;
      prop[k] = all_ones<S>(d[k]);
    }
    chains<K>(gen, prop, bin, below);  // the sum passes 2^(32N) exactly when p was added
#pragma unroll
    for (int k = 0; k < K; ++k) {
      inc_words<S>(d[k], bin[k]);
#pragma unroll
      for (int j = 0; j < S; ++j) r[k][j] = d[k][j];
    }
  }

  // r_k <- a_k b_k R^-1 mod p for K independent products (CIOS; r_k may
  // alias a_k or b_k), the N steps in lockstep over the K products.  The
  // step loop stays rolled (its body is 2KS multiply-adds and 3K shuffles):
  // unrolled, the formulas' dozens of multiplies made the kernel's code
  // too large to run from the instruction cache.  The value of a product
  // after step i is the sum over ranks of slice 2^(32 rank S) +
  // pend 2^(32 (rank + 1) S), pend the carry out of the rank's top word not
  // yet passed up (at most 3); the top rank's pend is the value's word N.
  template <int K>
  __device__ __forceinline__ void mul_k(uint32_t* const (&r)[K], const uint32_t* const (&a)[K],
                                        const uint32_t* const (&b)[K]) const {
    uint32_t av[K][S], bv[K][S], t[K][S], pend[K];
    const uint32_t n0 = kMontN0[kRow];
    const bool top_rank = g.rank == TPI - 1;
#pragma unroll
    for (int k = 0; k < K; ++k) {
#pragma unroll
      for (int j = 0; j < S; ++j) {
        av[k][j] = a[k][j];
        bv[k][j] = b[k][j];
        t[k][j] = 0;
      }
      pend[k] = 0;
    }
#pragma unroll 1
    for (int i = 0; i < N; ++i) {
      uint64_t acc[K];
      uint32_t bi[K], m[K], up[K];
      const int w = i % S;  // word i of b is word w of rank i / S
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint32_t v = bv[k][0];
#pragma unroll
        for (int j = 1; j < S; ++j) v = j == w ? bv[k][j] : v;
        bi[k] = g.shfl(v, i / S);
      }
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const uint64_t s = (uint64_t)av[k][j] * bi[k] + t[k][j] + c;
          t[k][j] = (uint32_t)s;
          c = s >> 32;
        }
        acc[k] = (uint64_t)pend[k] + c;
        m[k] = t[k][0] * n0;
      }
#pragma unroll
      for (int k = 0; k < K; ++k) m[k] = g.shfl(m[k], 0);  // rank 0's word 0 is the value's
#pragma unroll
      for (int k = 0; k < K; ++k) {
        uint64_t c = 0;
#pragma unroll
        for (int j = 0; j < S; ++j) {
          const uint64_t s = (uint64_t)m[k] * p[j] + t[k][j] + c;
          t[k][j] = (uint32_t)s;
          c = s >> 32;
        }
        acc[k] += c;
      }
      // word 0 of each value is now 0: drop it, every word moves down one
#pragma unroll
      for (int k = 0; k < K; ++k) up[k] = g.next(t[k][0]);
#pragma unroll
      for (int k = 0; k < K; ++k) {
#pragma unroll
        for (int j = 0; j + 1 < S; ++j) t[k][j] = t[k][j + 1];
        acc[k] += top_rank ? 0u : up[k];
        t[k][S - 1] = (uint32_t)acc[k];
        pend[k] = (uint32_t)(acc[k] >> 32);
      }
    }
    // pass each pend up one rank (at most a carry of 1 out of a slice),
    // then settle the carries across the ranks; each value is below 2p
    uint32_t in[K], word_n[K], o[K][S];
    bool gen[K], prop[K], cin[K], out[K], top[K];
#pragma unroll
    for (int k = 0; k < K; ++k) in[k] = g.prev(pend[k]);
#pragma unroll
    for (int k = 0; k < K; ++k) word_n[k] = g.shfl(pend[k], TPI - 1);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      gen[k] = inc_words<S>(t[k], g.rank == 0 ? 0u : in[k]) != 0;
      prop[k] = all_ones<S>(t[k]);
    }
    chains<K>(gen, prop, cin, out);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      inc_words<S>(t[k], cin[k]);
      top[k] = word_n[k] != 0 || out[k];
    }
    reduce_once<K>(o, t, top);
#pragma unroll
    for (int k = 0; k < K; ++k)
#pragma unroll
      for (int j = 0; j < S; ++j) r[k][j] = o[k][j];
  }

  // one op on one element
  __device__ __forceinline__ void add(uint32_t r[], const uint32_t a[], const uint32_t b[]) const {
    add_k<1>({r}, {a}, {b});
  }
  __device__ __forceinline__ void sub(uint32_t r[], const uint32_t a[], const uint32_t b[]) const {
    sub_k<1>({r}, {a}, {b});
  }
  __device__ __forceinline__ void mul(uint32_t r[], const uint32_t a[], const uint32_t b[]) const {
    mul_k<1>({r}, {a}, {b});
  }

  // r <- one, the Montgomery form of 1
  __device__ __forceinline__ void one(uint32_t r[]) const { slice(r, kMontOne[kRow]); }

  // words <- this rank's slice of a, at the words slice() reads
  __device__ __forceinline__ void put(uint32_t* words, const uint32_t a[]) const {
#pragma unroll
    for (int j = 0; j < S; ++j) words[g.rank * S + j] = a[j];
  }

  // r <- this rank's slice of the stored element (2N limbs) at src, as it is
  __device__ __forceinline__ void raw(uint32_t r[], const int32_t* src) const {
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int k = 2 * (g.rank * S + j);
      r[j] = (uint32_t)src[k] | ((uint32_t)src[k + 1] << 16);
    }
  }

  // r <- the Montgomery form of the stored element (2N limbs) at src
  __device__ __forceinline__ void load(uint32_t r[], const int32_t* src) const {
    uint32_t w[S], r2[S];
    raw(w, src);
    slice(r2, kMontR2[kRow]);
    mul(r, w, r2);
  }

  // r_k <- the Montgomery forms of K stored elements, in lockstep
  template <int K>
  __device__ __forceinline__ void load_k(uint32_t* const (&r)[K], const int32_t* const (&src)[K]) const {
    uint32_t w[K][S], r2[S];
    const uint32_t* a[K];
    const uint32_t* b[K];
    slice(r2, kMontR2[kRow]);
#pragma unroll
    for (int k = 0; k < K; ++k) {
      raw(w[k], src[k]);
      a[k] = w[k];
      b[k] = r2;
    }
    mul_k<K>(r, a, b);
  }

  // whether the stored element at src is 0, on every rank (a ballot)
  __device__ __forceinline__ bool is_zero(const int32_t* src) const {
    uint32_t w[S];
    raw(w, src);
    return g.ballot(all_zero<S>(w)) == (1u << TPI) - 1u;
  }

  // the canonical limbs of a to dst (computed by the whole group, written
  // only where dst is not null)
  __device__ __forceinline__ void store(int32_t* dst, const uint32_t a[]) const {
    uint32_t w[S], unit[S];
#pragma unroll
    for (int j = 0; j < S; ++j) unit[j] = (g.rank == 0 && j == 0) ? 1u : 0u;
    mul(w, a, unit);
    if (dst == nullptr) return;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      const int k = 2 * (g.rank * S + j);
      dst[k] = (int32_t)(w[j] & 0xFFFFu);
      dst[k + 1] = (int32_t)(w[j] >> 16);
    }
  }
};

// The curves' group operations.  Each names its point P (C coordinates
// of S words), identity, add and dbl (the formulas of point.cuh and
// edwards.cuh, op for op), and kDoubleFixesIdentity: whether dbl maps the
// stored identity to itself limb for limb (RCB15 doubling takes (0:1:0) to
// (0:1:0); hwcd doubling takes (0:1:1:0) to (0:-1:-1:0)), which lets the
// ladder skip the doublings of x's leading zero bits.

// Short Weierstrass a = 0 over C of point.cuh (RCB15 algorithms 7, 8 and
// 9).
template <class C, class G>
struct GroupWs {
  using GF = GField<C::F, G>;
  static constexpr int N = GF::N, S = GF::S, kCoords = dkg::kCoords;
  static constexpr bool kDoubleFixesIdentity = true, kWeierstrass = true;
  struct P {
    uint32_t x[S], y[S], z[S];
  };
  GF f;
  __device__ explicit GroupWs(const G& g) : f(g) {}

  // r_k <- b3 a_k: secp256k1 multiplies by 21 R mod p, BLS12-381 adds
  // ((a + a) + a) doubled twice, as point.cuh does (p has no fold)
  template <int K>
  __device__ __forceinline__ void mul_b3(uint32_t* const (&r)[K], const uint32_t* const (&a)[K]) const {
    if constexpr (C::F == kSecpP) {
      uint32_t k3[S];
      f.slice(k3, kMontB3Secp);
      const uint32_t* b[K];
#pragma unroll
      for (int k = 0; k < K; ++k) b[k] = k3;
      f.template mul_k<K>(r, a, b);
    } else {
      uint32_t t[K][S];
      uint32_t* tw[K];
      const uint32_t* tr[K];
#pragma unroll
      for (int k = 0; k < K; ++k) {
        tw[k] = t[k];
        tr[k] = t[k];
      }
      f.template add_k<K>(tw, a, a);
      f.template add_k<K>(tw, tr, a);
      f.template add_k<K>(tw, tr, tr);
      f.template add_k<K>(r, tr, tr);
    }
  }

  __device__ __forceinline__ void identity(P& p) const {
#pragma unroll
    for (int j = 0; j < S; ++j) p.x[j] = p.z[j] = 0;
    f.one(p.y);
  }

  // RCB15 algorithm 7 (point.cuh pt_add), each value by the same field ops
  // from the same operands; the independent ones in lockstep batches.  o
  // may alias p or q.
  __device__ __forceinline__ void add(P& o, const P& p, const P& q) const {
    uint32_t t0[S], t1[S], t2[S], t3[S], t4[S], y3[S], x3[S], z3[S];
    uint32_t u1[S], v1[S], u2[S], v2[S], u3[S], v3[S];
    f.template add_k<6>({u1, v1, u2, v2, u3, v3}, {p.x, q.x, p.y, q.y, p.x, q.x},
                        {p.y, q.y, p.z, q.z, p.z, q.z});
    f.template mul_k<6>({t0, t1, t2, t3, t4, y3}, {p.x, p.y, p.z, u1, u2, u3}, {q.x, q.y, q.z, v1, v2, v3});
    f.template sub_k<3>({t3, t4, y3}, {t3, t4, y3}, {t0, t1, t0});
    f.template sub_k<3>({t3, t4, y3}, {t3, t4, y3}, {t1, t2, t2});
    f.add(x3, t0, t0);
    f.add(x3, x3, t0);  // x3 = 3 t0
    mul_b3<2>({t2, y3}, {t2, y3});
    f.template add_k<1>({z3}, {t1}, {t2});
    f.template sub_k<1>({t1}, {t1}, {t2});
    f.template mul_k<6>({u1, v1, u2, v2, u3, v3}, {t3, t4, t1, x3, z3, x3}, {t1, y3, z3, y3, t4, t3});
    f.template sub_k<1>({o.x}, {u1}, {v1});  // X = t3 t1 - t4 y3
    f.template add_k<2>({o.y, o.z}, {u2, u3}, {v2, v3});  // Y = t1 z3 + x3 y3, Z = z3 t4 + x3 t3
  }

  // RCB15 algorithm 8 (point.cuh pt_madd), q affine: its Z is not read.
  // Complete for every p, not for q = identity (callers keep p there).  o
  // may alias p.
  __device__ __forceinline__ void madd(P& o, const P& p, const P& q) const {
    uint32_t t0[S], t1[S], t2[S], t3[S], t4[S], y3[S], x3[S], z3[S], u[S], v[S];
    uint32_t u1[S], v1[S], u2[S], v2[S], u3[S], v3[S];
    f.template add_k<2>({u, v}, {p.x, q.x}, {p.y, q.y});
    f.template mul_k<5>({t0, t1, t3, t4, y3}, {p.x, p.y, u, q.y, q.x}, {q.x, q.y, v, p.z, p.z});
    f.template add_k<3>({t4, y3, x3}, {t4, y3, t0}, {p.y, p.x, t0});  // t4 = y2 z1 + y1, y3 = x2 z1 + x1
    f.sub(t3, t3, t0);
    f.sub(t3, t3, t1);  // t3 = x1 y2 + x2 y1
    f.add(x3, x3, t0);  // x3 = 3 t0
    mul_b3<2>({t2, y3}, {p.z, y3});
    f.add(z3, t1, t2);
    f.sub(t1, t1, t2);
    f.template mul_k<6>({u1, v1, u2, v2, u3, v3}, {t3, t4, t1, x3, z3, x3}, {t1, y3, z3, y3, t4, t3});
    f.sub(o.x, u1, v1);
    f.template add_k<2>({o.y, o.z}, {u2, u3}, {v2, v3});
  }

  // RCB15 algorithm 9 (point.cuh pt_double), in place; x y is formed with
  // the first products (its operands do not change before the reference
  // forms it).
  __device__ __forceinline__ void dbl(P& p) const {
    uint32_t t0[S], t1[S], t2[S], xy[S], x3[S], y3[S], z3[S];
    f.template mul_k<4>({t0, t1, t2, xy}, {p.y, p.y, p.z, p.x}, {p.y, p.z, p.z, p.y});
    f.add(z3, t0, t0);
    f.add(z3, z3, z3);
    f.add(z3, z3, z3);  // z3 = 8 t0
    mul_b3<1>({t2}, {t2});
    f.template mul_k<2>({x3, z3}, {t2, t1}, {z3, z3});
    f.template add_k<2>({y3, t1}, {t0, t2}, {t2, t2});
    f.add(t2, t1, t2);  // t2 = 3 b3 z^2
    f.sub(t0, t0, t2);
    f.template mul_k<2>({t1, t2}, {t0, t0}, {y3, xy});  // t1 = t0 y3, t2 = t0 x y
    f.template add_k<2>({p.y, p.x}, {x3, t2}, {t1, t2});
#pragma unroll
    for (int j = 0; j < S; ++j) p.z[j] = z3[j];
  }

  __device__ __forceinline__ void load(P& p, const int32_t* src) const {
    f.load(p.x, src);
    f.load(p.y, src + 2 * N);
    f.load(p.z, src + 4 * N);
  }
  __device__ __forceinline__ void store(int32_t* dst, const P& p) const {
    f.store(dst, p.x);
    f.store(dst ? dst + 2 * N : dst, p.y);
    f.store(dst ? dst + 4 * N : dst, p.z);
  }
  // o <- take ? a : b, word by word (take the group's)
  __device__ __forceinline__ void select(P& o, bool take, const P& a, const P& b) const {
    const uint32_t mk = 0u - (uint32_t)take;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      o.x[j] = (a.x[j] & mk) | (b.x[j] & ~mk);
      o.y[j] = (a.y[j] & mk) | (b.y[j] & ~mk);
      o.z[j] = (a.z[j] & mk) | (b.z[j] & ~mk);
    }
  }
  // from Montgomery words staged by stage(): coordinate c at words + c N
  __device__ __forceinline__ void load_words(P& p, const uint32_t* words) const {
    f.slice(p.x, words);
    f.slice(p.y, words + N);
    f.slice(p.z, words + 2 * N);
  }
  // this rank's slice of each coordinate to words, as load_words reads it
  __device__ __forceinline__ void store_words(uint32_t* words, const P& p) const {
    f.put(words, p.x);
    f.put(words + N, p.y);
    f.put(words + 2 * N, p.z);
  }
  // an affine entry (X, Y of the stored point at src; Z is taken as 1)
  __device__ __forceinline__ void load_affine(P& p, const int32_t* src) const {
    f.template load_k<2>({p.x, p.y}, {src, src + 2 * N});
    f.one(p.z);
  }
  // whether the stored point at src has Z = 0 (the same on every rank)
  __device__ __forceinline__ bool z_is_zero(const int32_t* src) const {
    return f.is_zero(src + 4 * N);
  }
  __device__ __forceinline__ bool any(bool p) const { return f.g.any(p); }
};

// edwards25519 (a = -1) over the ed25519 base field: add-2008-hwcd-3 and
// dbl-2008-hwcd (edwards.cuh ed_add and ed_double).
struct Edwards25519 {
  static constexpr int F = kEdP;
  static constexpr int N = Field<F>::N;
};

template <class C, class G>
struct GroupEd {
  using GF = GField<C::F, G>;
  static constexpr int N = GF::N, S = GF::S, kCoords = kEdCoords;
  static constexpr bool kDoubleFixesIdentity = false;
  struct P {
    uint32_t x[S], y[S], z[S], t[S];
  };
  GF f;
  __device__ explicit GroupEd(const G& g) : f(g) {}

  __device__ __forceinline__ void identity(P& p) const {
#pragma unroll
    for (int j = 0; j < S; ++j) p.x[j] = p.t[j] = 0;
    f.one(p.y);
    f.one(p.z);
  }

  // (E, F, G, H) = (B - A, D - C, D + C, B + A); X = E F, Y = G H,
  // Z = F G, T = E H (edwards.cuh ed_finish)
  __device__ __forceinline__ void finish(P& o, const uint32_t a[], const uint32_t b[],
                                         const uint32_t c[], const uint32_t d[]) const {
    uint32_t e[S], ff[S], gg[S], h[S];
    f.template sub_k<2>({e, ff}, {b, d}, {a, c});
    f.template add_k<2>({gg, h}, {d, b}, {c, a});
    f.template mul_k<4>({o.x, o.y, o.z, o.t}, {e, gg, ff, e}, {ff, h, gg, h});
  }

  // add-2008-hwcd-3 (edwards.cuh ed_add), each value by the same field ops
  // from the same operands, the independent ones in lockstep.  o may alias
  // p or q.
  __device__ __forceinline__ void add(P& o, const P& p, const P& q) const {
    uint32_t a[S], b[S], c[S], d[S], u[S], v[S], w[S], z[S], k2d[S];
    f.template sub_k<2>({u, v}, {p.y, q.y}, {p.x, q.x});
    f.template add_k<3>({w, z, d}, {p.y, q.y, p.z}, {p.x, q.x, p.z});
    f.slice(k2d, kMontEd2D);
    f.template mul_k<4>({a, b, c, d}, {u, w, p.t, d}, {v, z, k2d, q.z});  // A, B, T1 2d, D = 2 Z1 Z2
    f.mul(c, c, q.t);                                                     // C = (T1 2d) T2
    finish(o, a, b, c, d);
  }

  // dbl-2008-hwcd, a = -1 (edwards.cuh ed_double), in place.
  __device__ __forceinline__ void dbl(P& p) const {
    uint32_t a[S], b[S], c[S], d[S], e[S], ff[S], gg[S], h[S], zero[S];
#pragma unroll
    for (int j = 0; j < S; ++j) zero[j] = 0;
    f.add(e, p.x, p.y);
    f.template mul_k<4>({a, b, c, e}, {p.x, p.y, p.z, e}, {p.x, p.y, p.z, e});  // X^2, Y^2, Z^2, (X + Y)^2
    f.add(c, c, c);
    f.sub(d, zero, a);  // D = -A
    f.sub(e, e, a);
    f.sub(e, e, b);
    f.add(gg, d, b);
    f.sub(h, d, b);
    f.sub(ff, gg, c);
    f.template mul_k<4>({p.x, p.y, p.z, p.t}, {e, gg, ff, e}, {ff, h, gg, h});
  }

  __device__ __forceinline__ void load(P& p, const int32_t* src) const {
    f.load(p.x, src);
    f.load(p.y, src + 2 * N);
    f.load(p.z, src + 4 * N);
    f.load(p.t, src + 6 * N);
  }
  __device__ __forceinline__ void store(int32_t* dst, const P& p) const {
    f.store(dst, p.x);
    f.store(dst ? dst + 2 * N : dst, p.y);
    f.store(dst ? dst + 4 * N : dst, p.z);
    f.store(dst ? dst + 6 * N : dst, p.t);
  }
  __device__ __forceinline__ void select(P& o, bool take, const P& a, const P& b) const {
    const uint32_t mk = 0u - (uint32_t)take;
#pragma unroll
    for (int j = 0; j < S; ++j) {
      o.x[j] = (a.x[j] & mk) | (b.x[j] & ~mk);
      o.y[j] = (a.y[j] & mk) | (b.y[j] & ~mk);
      o.z[j] = (a.z[j] & mk) | (b.z[j] & ~mk);
      o.t[j] = (a.t[j] & mk) | (b.t[j] & ~mk);
    }
  }
  __device__ __forceinline__ void load_words(P& p, const uint32_t* words) const {
    f.slice(p.x, words);
    f.slice(p.y, words + N);
    f.slice(p.z, words + 2 * N);
    f.slice(p.t, words + 3 * N);
  }
};

// Coefficient sources of the Horner lane: D_l as Montgomery words staged
// once a block (shared by every lane), or as stored limbs of the lane's
// own row (per-lane coefficients), converted at each step.
template <class K>
struct StagedCoeffs {
  const uint32_t* words;  // (T, C, N) Montgomery words
  __device__ __forceinline__ void get(const K& k, int l, typename K::P& d) const {
    k.load_words(d, words + (int64_t)l * K::kCoords * K::N);
  }
};

template <class K>
struct LimbCoeffs {
  const int32_t* limbs;  // (T, C, 2N) stored limbs of the lane's row
  __device__ __forceinline__ void get(const K& k, int l, typename K::P& d) const {
    k.load(d, limbs + (int64_t)l * K::kCoords * 2 * K::N);
  }
};

// words <- the Montgomery words of count stored coordinates at limbs, the
// coordinates first, first + stride, ... converted by this group (one of
// stride groups sharing the work; every group makes the same number of
// passes, so the loop is warp-uniform).
template <class K>
__device__ __forceinline__ void stage_coords(const K& k, uint32_t* words, const int32_t* limbs,
                                             int64_t count, int64_t first, int64_t stride) {
  constexpr int S = K::S, N = K::N;
  for (int64_t e0 = 0; e0 < count; e0 += stride) {
    const int64_t e = e0 + first < count ? e0 + first : count - 1;
    uint32_t w[S];
    k.f.load(w, limbs + e * 2 * N);
    if (e0 + first < count) {
#pragma unroll
      for (int j = 0; j < S; ++j) words[e * N + k.f.g.rank * S + j] = w[j];
    }
  }
}

// One lane's point Horner: acc <- x acc + D_l for l = T-1 .. 0 from the
// identity, out <- acc (not written where out is null).  Each step is
// pt_ladder_mul_add's ladder (point.cuh ladder_lane: MSB-first over nbits
// bits of x, a doubling, then an add kept where the bit is set) without
// the work its select throws away, as far as a warp allows: the warp runs
// a bit's add only if one of its groups has the bit set (the others keep
// their sum by the select, as the reference does), and, where dbl fixes
// the identity, a bit's doubling only if one of its groups is past its
// top set bit (in the others the sum is still the identity, which the
// doubling keeps).  The control flow is the warp's, so every group runs
// every collective op together.  x is public: neighbouring lanes hold
// neighbouring x, so a warp's groups share x's high bits.
template <class K, class Src>
__device__ __forceinline__ void ladder_horner_lane(const K& k, const Src& src, uint32_t x,
                                                   int nbits, int T, int32_t* out) {
  typename K::P acc, m, t, d;
  const auto& g = k.f.g;
  k.identity(acc);
  if (nbits < 32) x &= (1u << nbits) - 1u;
  int top = nbits;  // the bits below top double
  if constexpr (K::kDoubleFixesIdentity) {
    top = -1;
    for (int i = nbits - 1; i >= 0; --i)
      if ((x >> i) & 1u) {
        top = i;
        break;
      }
  }
#pragma unroll 1
  for (int l = T - 1; l >= 0; --l) {
    k.identity(m);
#pragma unroll 1
    for (int i = nbits - 1; i >= 0; --i) {
      if (g.any(i < top)) k.dbl(m);
      const bool bit = (x >> i) & 1u;
      if (g.any(bit)) {
        k.add(t, m, acc);
        k.select(m, bit, t, m);
      }
    }
    src.get(k, l, d);
    k.add(acc, m, d);
  }
  k.store(out, acc);
}

}  // namespace dkg
