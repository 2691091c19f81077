// The bodies of the three chained point kernels of chain_kernels.cu, over
// any point kind: pt_fixed_base (all windows of fixed_base_mul, one lane
// each), pt_scalar_mul (all windows of scalar_mul, one lane each) and
// pt_tree_sum (a column's pairwise tree of adds, one block each).  Shared
// with csrc/host_check.cpp, which runs them on the host.
//
// A kind K names a point type P and its ops: identity, add, madd (q
// affine), dbl (in place), load (a stored point), load_affine (a stored
// table entry, Z taken as 1), store (nothing where dst is null), select, z_is_zero
// (Weierstrass only), store_words / load_words (a point in shared
// memory, C N words), and any (a vote: whether p holds for any lane of
// the warp, or, at one thread a lane, p itself).  group.cuh's GroupWs
// spreads a lane over TPI threads in Montgomery form; LaneWs and LaneEd
// below run a lane on one thread over field.cuh's core (point.cuh and
// edwards.cuh, canonical residues, no conversion).  Every op is exact, so
// every kind gives the same limbs.
#pragma once

#include "edwards.cuh"
#include "group.cuh"
#include "point.cuh"

namespace dkg {

// One thread a lane on the short Weierstrass curve C (point.cuh).
template <class C>
struct LaneWs {
  static constexpr int kTpi = 1, N = C::N, kCoords = dkg::kCoords;
  static constexpr bool kWeierstrass = true;
  using P = Point<C>;
  __device__ __forceinline__ void identity(P& p) const { set_identity(p); }
  __device__ __forceinline__ void add(P& o, const P& p, const P& q) const { pt_add(o, p, q); }
  __device__ __forceinline__ void madd(P& o, const P& p, const P& q) const { pt_madd(o, p, q); }
  __device__ __forceinline__ void dbl(P& p) const { pt_double(p); }
  __device__ __forceinline__ void load(P& p, const int32_t* src) const { load_point(src, p); }
  __device__ __forceinline__ void load_affine(P& p, const int32_t* src) const {
    load_elem<N>(src, p.x);
    load_elem<N>(src + 2 * N, p.y);
  }
  __device__ __forceinline__ void store(int32_t* dst, const P& p) const {
    if (dst != nullptr) store_point(dst, p);
  }
  __device__ __forceinline__ void select(P& o, bool take, const P& a, const P& b) const {
    select_point(o, take, a, b);
  }
  __device__ __forceinline__ bool z_is_zero(const int32_t* src) const {
    uint32_t z[N];
    load_elem<N>(src + 4 * N, z);
    uint32_t v = 0;
#pragma unroll
    for (int k = 0; k < N; ++k) v |= z[k];
    return v == 0;
  }
  __device__ __forceinline__ void store_words(uint32_t* w, const P& p) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      w[k] = p.x[k];
      w[N + k] = p.y[k];
      w[2 * N + k] = p.z[k];
    }
  }
  __device__ __forceinline__ void load_words(P& p, const uint32_t* w) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      p.x[k] = w[k];
      p.y[k] = w[N + k];
      p.z[k] = w[2 * N + k];
    }
  }
  __device__ __forceinline__ bool any(bool p) const { return p; }
};

// One thread a lane on edwards25519 (edwards.cuh).
struct LaneEd {
  static constexpr int kTpi = 1, N = kEdN, kCoords = kEdCoords;
  static constexpr bool kWeierstrass = false;
  using P = EdPoint;
  __device__ __forceinline__ void identity(P& p) const { ed_set_identity(p); }
  __device__ __forceinline__ void add(P& o, const P& p, const P& q) const { ed_add(o, p, q); }
  __device__ __forceinline__ void madd(P& o, const P& p, const P& q) const { ed_madd(o, p, q); }
  __device__ __forceinline__ void dbl(P& p) const { ed_double(p); }
  __device__ __forceinline__ void load(P& p, const int32_t* src) const { load_ed(src, p); }
  __device__ __forceinline__ void load_affine(P& p, const int32_t* src) const {
    load_elem<N>(src, p.x);
    load_elem<N>(src + kEdLimbs, p.y);
    load_elem<N>(src + 3 * kEdLimbs, p.t);
  }
  __device__ __forceinline__ void store(int32_t* dst, const P& p) const {
    if (dst != nullptr) store_ed(dst, p);
  }
  __device__ __forceinline__ void store_words(uint32_t* w, const P& p) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      w[k] = p.x[k];
      w[N + k] = p.y[k];
      w[2 * N + k] = p.z[k];
      w[3 * N + k] = p.t[k];
    }
  }
  __device__ __forceinline__ void load_words(P& p, const uint32_t* w) const {
#pragma unroll
    for (int k = 0; k < N; ++k) {
      p.x[k] = w[k];
      p.y[k] = w[N + k];
      p.z[k] = w[2 * N + k];
      p.t[k] = w[3 * N + k];
    }
  }
  __device__ __forceinline__ bool any(bool p) const { return p; }
};

#ifdef __CUDACC__
// The kind at group size TPI: group.cuh's over a warp group, or at
// TPI = 1 the one-thread kinds above (the card only: WarpGroup reads
// threadIdx).
template <template <class, class> class Kind, class C, int TPI>
struct KindAt {
  using type = Kind<C, WarpGroup<TPI>>;
  static __device__ __forceinline__ type make() { return type{WarpGroup<TPI>(threadIdx.x)}; }
};
template <class C>
struct KindAt<GroupWs, C, 1> {
  using type = LaneWs<C>;
  static __device__ __forceinline__ type make() { return type{}; }
};
template <class C>
struct KindAt<GroupEd, C, 1> {
  using type = LaneEd;
  static __device__ __forceinline__ type make() { return type{}; }
};
#endif

// int32 limbs of a stored point of kind K, and 32-bit words of one in
// shared memory
template <class K>
__host__ __device__ constexpr int stored_limbs() {
  return K::kCoords * 2 * K::N;
}
template <class K>
__host__ __device__ constexpr int point_smem_words() {
  return K::kCoords * K::N;
}

// k B for a fixed B, one lane: table (nw, 2^window, C, 2N) affine entries
// T[w][d] = d 2^(window w) B, the scalar's 16-bit limbs at k; out <- the
// sum over windows w of T[w][digit w] by mixed adds from the identity, in
// the order of groups/device.py fixed_base_mul.  Digit w is bits
// [window w, window (w + 1)) of k, which lie in one limb (window divides
// 16).  On the Weierstrass curves an entry with Z = 0 (digit 0, or any
// entry of the identity's table) keeps the accumulator, which the mixed
// add cannot take; the warp skips a window's add where no lane needs it.
template <class K>
__device__ __forceinline__ void fixed_base_lane(const K& k, const int32_t* table, const int32_t* scalar,
                                                int nw, int window, int32_t* out) {
  typename K::P acc, e, t;
  k.identity(acc);
  const uint32_t mask = (1u << window) - 1u;
#pragma unroll 1
  for (int w = 0; w < nw; ++w) {
    const int bit = w * window;
    const uint32_t d = ((uint32_t)scalar[bit >> 4] >> (bit & 15)) & mask;
    const int32_t* entry = table + (((int64_t)w << window) + d) * stored_limbs<K>();
    if constexpr (K::kWeierstrass) {
      const bool keep = k.z_is_zero(entry);
      if (k.any(!keep)) {
        k.load_affine(e, entry);
        k.madd(t, acc, e);
        k.select(acc, keep, acc, t);
      }
    } else {
      k.load_affine(e, entry);
      k.madd(acc, acc, e);
    }
  }
  k.store(out, acc);
}

// k P, one lane: table (2^window, C, 2N) the lane's entries d P (entry 0
// the identity), the scalar's 16-bit limbs at k; out <- from the
// identity, for each window w from the top (nw of them), window doublings
// and a complete add of entry digit w, the order of groups/device.py
// scalar_mul (and of the JAX package's _scalar_mul_core): digit 0 adds the
// identity, and the doublings of the leading windows double the identity
// (which hwcd doubling does not keep limb for limb), as there.  The
// accumulator stays in registers for every window; the entries are read
// where they lie.
template <class K>
__device__ __forceinline__ void scalar_mul_lane(const K& k, const int32_t* table, const int32_t* scalar,
                                                int nw, int window, int32_t* out) {
  typename K::P acc, e;
  k.identity(acc);
  const uint32_t mask = (1u << window) - 1u;
#pragma unroll 1
  for (int w = nw - 1; w >= 0; --w) {
#pragma unroll 1
    for (int i = 0; i < window; ++i) k.dbl(acc);
    const int bit = w * window;
    const uint32_t d = ((uint32_t)scalar[bit >> 4] >> (bit & 15)) & mask;
    k.load(e, table + (int64_t)d * stored_limbs<K>());
    k.add(acc, acc, e);
  }
  k.store(out, acc);
}

// Leaf j of a column's chunk: the stored point at base + j sj, or, with
// digits, entry digits[j dsj] of the table at base + j sj (the gathered
// mode: the entries are read in place).
template <class K>
struct Leaves {
  const int32_t* base;
  int64_t sj;
  const int32_t* digits;
  int64_t dsj;
  __device__ __forceinline__ const int32_t* at(int64_t j) const {
    const int32_t* p = base + j * sj;
    return digits != nullptr ? p + (int64_t)digits[j * dsj] * stored_limbs<K>() : p;
  }
};

// The pairwise tree of groups/device.py _tree_reduce over cnt leaves, run
// for exactly `levels` levels by one block of Blk::groups() lanes (groups
// of TPI threads): level l adds nodes (2i, 2i + 1) of level l - 1, and
// where that level has an odd count its last node is added to the
// identity, as the reference pads it.  levels = ceil(log2 cnt) is the
// whole tree; a chunk of a longer column runs its chunk's levels even
// where it has fewer leaves (the lone last chunk), since the whole tree
// adds the identity to that chunk's node at each of them.  Level 1 reads
// the leaves from device memory and every later level the nodes in
// shared memory (words: 2^(levels - 1) points), in place: a round of
// Blk::groups() nodes reads its operands, meets the block at a barrier
// and only then writes, and no later round reads a slot that an earlier
// round of the level wrote.  Lanes past the level's last node run its
// add again without writing (the warp runs every collective op together)
// where a lane of the warp has a node, and skip it where none has.
// out <- the top node (written by the block's first lane).  Every path
// ends in the same read of slot 0: with an early return for the one-leaf
// case instead, ptxas at -O3 built an edwards25519 one-thread kernel that
// read another column's leaf or faulted on a misaligned address there,
// from PTX that was right (and right at -O1).
template <class K, class Blk>
__device__ __forceinline__ void tree_block(const K& k, const Blk& blk, uint32_t* words,
                                           const Leaves<K>& leaves, int64_t cnt, int levels,
                                           int32_t* out) {
  constexpr int PW = point_smem_words<K>();
  typename K::P a, b;
  const int G = blk.groups(), gid = blk.group();
  if (levels == 0) {  // one leaf, no add: it is the top node (written by the first warp's first lane)
    if (k.any(gid == 0)) {
      k.load(a, leaves.at(0));
      if (gid == 0) k.store_words(words, a);
    }
    blk.sync();
  }
  int64_t cur = cnt;
#pragma unroll 1
  for (int lev = 1; lev <= levels; ++lev) {
    const int64_t nxt = (cur + 1) / 2;
#pragma unroll 1
    for (int64_t r0 = 0; r0 < nxt; r0 += G) {
      const int64_t i = r0 + gid;
      const bool active = i < nxt;
      const int64_t ic = active ? i : nxt - 1;
      const bool pair = 2 * ic + 1 < cur;
      const bool work = k.any(active);
      if (work) {
        const int64_t j = pair ? 2 * ic + 1 : 2 * ic;
        if (lev == 1) {
          k.load(a, leaves.at(2 * ic));
          k.load(b, leaves.at(j));
        } else {
          k.load_words(a, words + 2 * ic * PW);
          k.load_words(b, words + j * PW);
        }
        if (!pair) k.identity(b);
      }
      if (lev > 1) blk.sync();
      if (work) {
        k.add(a, a, b);
        if (active) k.store_words(words + i * PW, a);
      }
    }
    blk.sync();
    cur = nxt;
  }
  k.load_words(a, words);
  k.store(gid == 0 ? out : nullptr, a);
}

}  // namespace dkg
