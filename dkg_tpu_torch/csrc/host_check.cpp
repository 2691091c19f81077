// The kernels' per-lane bodies compiled for the host, one loop over lanes
// in place of the grid.  The CPU tests build this file with the host
// compiler (g++ -O1 -shared -fPIC) and hold every entry against the plain
// PyTorch version of its kernel: it runs the same field.cuh, point.cuh,
// edwards.cuh and bucket.cuh code that field_kernels.cu, point_kernels.cu,
// edwards_kernels.cu, double_kernels.cu, bucket_kernels.cu and
// bls_kernels.cu run on the card, the three reductions (fold at 2^256,
// fold at 2^255, Barrett at 8 and 12 words) included, and the fused
// multiply-reduce of mxu.cuh (mxu_kernels.cu), whole and from its two
// inner steps, so its integer bounds can be driven to their worst cases.
// The multi-step kernels too: mod_madd_horner and mod_madd_dot's lane
// bodies (horner.cuh), and pt_ladder_horner's (group.cuh), whose warp is
// 32 fibers on the calling thread: its TPI threads a lane meet at a
// barrier for each shuffle and ballot, and all 32 for each of the warp's
// votes.  And the chained point kernels of chain_kernels.cu (chain.cuh):
// pt_fixed_base's and pt_scalar_mul's lanes and pt_tree_sum's block
// (whose threads also meet at a barrier for each __syncthreads), at one
// thread a lane or, where chain_kernels.cu builds it, a group of TPI.
// And mod_batch_inv's column (inv.cuh, inv_kernels.cu).  And the tensor-
// core multiply-reduce of mxu_warp.cuh (alone, and in mxu_kernels.cu's
// mxu_batch_inv column), whose warp is 32 fibers and whose mma is built
// from the PTX ISA's fragment tables for m16n8k32; and pt_bucket_sum's and
// pt_bucket_close's lanes (pippenger.cuh, pippenger_kernels.cu) with the
// kernels' lane maps, the close at one thread a lane or a group of TPI.
#include <ucontext.h>

#include <functional>
#include <memory>
#include <vector>

#include "bucket.cuh"
#include "chain.cuh"
#include "group.cuh"
#include "horner.cuh"
#include "inv.cuh"
#include "mxu_warp.cuh"
#include "pippenger.cuh"

using namespace dkg;

namespace {
template <class C>
constexpr int kPW = point_words<C>();
constexpr int kEdPointWords = kEdCoords * kEdLimbs;

template <int F>
void mod_madd_lanes(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out,
                    int64_t n) {
  constexpr int N = Field<F>::N;
  for (int64_t lane = 0; lane < n; ++lane) {
    uint32_t x[N], y[N], z[N], r[N];
    load_elem<N>(a + lane * 2 * N, x);
    load_elem<N>(b + lane * 2 * N, y);
    load_elem<N>(c + lane * 2 * N, z);
    fmadd<F>(r, x, y, z);
    store_elem<N>(out + lane * 2 * N, r);
  }
}

// inv_kernels.cu's mod_batch_inv_kernel, a column at a time.
template <int F>
void batch_inv_columns(const int32_t* x, int32_t* out, int64_t rows, int64_t cols,
                       const int32_t* chain, int chain_len, int npow) {
  constexpr int L = 2 * Field<F>::N;
  for (int64_t col = 0; col < cols; ++col)
    batch_inv_column<F>(x + col * L, out + col * L, rows, cols * L, chain, chain_len, npow);
}

template <int F>
void mod_mul_lanes(const int32_t* a, const int32_t* b, int32_t* out, int64_t n) {
  constexpr int N = Field<F>::N;
  for (int64_t lane = 0; lane < n; ++lane) {
    uint32_t x[N], y[N], r[N];
    load_elem<N>(a + lane * 2 * N, x);
    load_elem<N>(b + lane * 2 * N, y);
    fmul<F>(r, x, y);
    store_elem<N>(out + lane * 2 * N, r);
  }
}

// mode 0: (a, b) -> a * b mod p, the kernel's lane; mode 1: 2L columns
// at a -> their value mod p (steps 2 to 8); mode 2: L + 1 normalized
// limbs at a -> their value mod p (steps 7 and 8).
template <int L>
void mxu_lanes(int mode, const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
               const MulRed& k) {
  for (int64_t lane = 0; lane < n; ++lane) {
    if (mode == 0) {
      mxu_mul_lane<L>(a + lane * L, b + lane * L, out + lane * L, k);
      continue;
    }
    uint32_t col[2 * L], v[L + 1], r[L];
    if (mode == 1) {
      for (int j = 0; j < 2 * L; ++j) col[j] = (uint32_t)a[lane * 2 * L + j];
      mxu_fold<L>(col, v, k);
    } else {
      for (int j = 0; j <= L; ++j) v[j] = (uint32_t)a[lane * (L + 1) + j];
    }
    mxu_quotient<L>(v, r, k);
    for (int j = 0; j < L; ++j) out[lane * L + j] = (int32_t)r[j];
  }
}

// Every bucket (b, w, e) of bucket_kernels.cu and bls_kernels.cu, one
// after another: the same bucket_fold over the whole digit column of
// window w.
template <class K>
void bucket_lanes(const int32_t* pts, const int32_t* digits, int32_t* out, int64_t batch,
                  int64_t m, int nw, int window, int64_t dig_batch_stride) {
  const int entries = 1 << window;
  for (int64_t b = 0; b < batch; ++b)
    for (int w = 0; w < nw; ++w)
      for (int e = 0; e < entries; ++e) {
        typename K::P acc;
        K::identity(acc);
        bucket_fold<K>(acc, pts + b * m * K::kPointWords, digits + b * dig_batch_stride + w, nw,
                       m, e);
        K::store(out + ((b * nw + w) * entries + e) * K::kPointWords, acc);
      }
}

template <class C>
void add_lanes(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane)
    add_lane<C>(p + lane * kPW<C>, q + lane * kPW<C>, out + lane * kPW<C>);
}

template <class C>
void madd_lanes(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane)
    madd_lane<C>(p + lane * kPW<C>, q + lane * kPW<C>, out + lane * kPW<C>);
}

template <class C>
void window_step_lanes(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                       int n_doubles) {
  for (int64_t lane = 0; lane < n; ++lane)
    window_step_lane<C>(acc + lane * kPW<C>, entry + lane * kPW<C>, n_doubles,
                        out + lane * kPW<C>);
}

template <class C>
void ladder_lanes(const int32_t* p, const int32_t* addend, const int32_t* x, int32_t* out,
                  int64_t n, int nbits) {
  for (int64_t lane = 0; lane < n; ++lane)
    ladder_lane<C>(p + lane * kPW<C>, addend + lane * kPW<C>, (uint32_t)x[lane], nbits,
                   out + lane * kPW<C>);
}

template <class C>
void double_lanes(const int32_t* p, int32_t* out, int64_t n, int n_doubles) {
  for (int64_t lane = 0; lane < n; ++lane)
    double_lane<C>(p + lane * kPW<C>, n_doubles, out + lane * kPW<C>);
}
// field_kernels.cu's mod_madd_horner_kernel, a point at a time, with the
// coefficients in the kernel's chunks (kHornerChunk from the top).
template <int F>
void horner_lanes(const int32_t* coeffs, int64_t coeff_stride, const int32_t* xs,
                  int64_t xs_stride, int32_t* out, int64_t rows, int64_t npts, int T) {
  constexpr int N = Field<F>::N;
  for (int64_t r = 0; r < rows; ++r)
    for (int64_t i = 0; i < npts; ++i) {
      uint32_t x[N], acc[N] = {0};
      load_elem<N>(xs + r * xs_stride + i * 2 * N, x);
      for (int hi = T; hi > 0; hi -= kHornerChunk) {
        const int lo = hi > kHornerChunk ? hi - kHornerChunk : 0;
        horner_steps<F>(acc, x, coeffs + r * coeff_stride + lo * 2 * N, hi - lo);
      }
      store_elem<N>(out + (r * npts + i) * 2 * N, acc);
    }
}

// field_kernels.cu's mod_madd_dot_kernel, a lane at a time: its slices'
// partial sums, then slice 0 adding the others in order.
template <int F>
void dot_lanes(const int32_t* w, const int32_t* v, int32_t* out, int64_t m, int64_t K,
               int slices) {
  constexpr int N = Field<F>::N;
  for (int64_t k = 0; k < K; ++k) {
    uint32_t acc[N] = {0};
    dot_steps<F>(acc, w, v, m, K, k, 0, slices);
    for (int s = 1; s < slices; ++s) {
      uint32_t part[N] = {0};
      dot_steps<F>(part, w, v, m, K, k, s, slices);
      fadd<F>(acc, acc, part);
    }
    store_elem<N>(out + k * 2 * N, acc);
  }
}

// The threads of a warp (or a block) run as fibers on the calling thread:
// each runs until it waits at an Exchange, then the next one in turn, so a
// barrier costs a context switch whatever the machine's load (as OS
// threads, a waiting thread held a core the others needed).
struct Fibers {
  struct Fiber {
    ucontext_t ctx;
    std::function<void()> fn;
    bool done = false;
  };
  static constexpr size_t kStack = 1 << 20;
  std::vector<Fiber> fibers;
  ucontext_t main;
  size_t cur = 0;
  static Fibers*& active() {
    static Fibers* f = nullptr;
    return f;
  }
  static std::vector<std::unique_ptr<char[]>>& stacks() {  // kept for the next run
    static std::vector<std::unique_ptr<char[]>> s;
    return s;
  }
  static void entry() {
    Fibers* f = active();
    f->fibers[f->cur].fn();
    f->fibers[f->cur].done = true;  // then back to main through uc_link
  }
  // each fn to its end, in turns
  void run(std::vector<std::function<void()>> fns) {
    fibers.resize(fns.size());
    while (stacks().size() < fns.size()) stacks().emplace_back(new char[kStack]);
    for (size_t i = 0; i < fns.size(); ++i) {
      Fiber& fb = fibers[i];
      fb.fn = std::move(fns[i]);
      getcontext(&fb.ctx);
      fb.ctx.uc_stack.ss_sp = stacks()[i].get();
      fb.ctx.uc_stack.ss_size = kStack;
      fb.ctx.uc_link = &main;
      makecontext(&fb.ctx, &Fibers::entry, 0);
    }
    Fibers* outer = active();
    active() = this;
    for (bool left = true; left;) {
      left = false;
      for (cur = 0; cur < fibers.size(); ++cur) {
        if (fibers[cur].done) continue;
        swapcontext(&main, &fibers[cur].ctx);
        left = left || !fibers[cur].done;
      }
    }
    active() = outer;
  }
  // the running fiber lets the next one run
  static void yield() {
    Fibers* f = active();
    swapcontext(&f->fibers[f->cur].ctx, &f->main);
  }
};

// A warp as fibers: each group of TPI threads shuffles and ballots
// through its own slots and barrier, and the warp's votes (any) go
// through one shared by all its threads.  Each exchange writes the
// thread's value to a slot, meets the others at the barrier, reads, and
// meets them again before the slots are reused.
struct Exchange {
  int threads;
  int count = 0, generation = 0;
  uint32_t slot[32];
  void sync() {
    const int gen = generation;
    if (++count == threads) {
      count = 0;
      ++generation;
      return;
    }
    while (generation == gen) Fibers::yield();
  }
};

template <int TPI>
struct HostGroup {
  static constexpr int kTpi = TPI;
  uint32_t rank;
  Exchange* group;
  Exchange* warp;
  int warp_lane;
  uint32_t shfl(uint32_t v, int src) const {
    group->slot[rank] = v;
    group->sync();
    const uint32_t r = group->slot[src];
    group->sync();
    return r;
  }
  uint32_t next(uint32_t v) const { return shfl(v, rank + 1 < TPI ? rank + 1 : rank); }
  uint32_t prev(uint32_t v) const { return shfl(v, rank > 0 ? rank - 1 : rank); }
  uint32_t ballot(bool p) const {
    group->slot[rank] = p;
    group->sync();
    uint32_t bits = 0;
    for (int r = 0; r < TPI; ++r) bits |= (group->slot[r] != 0) << r;
    group->sync();
    return bits;
  }
  bool any(bool p) const {
    warp->slot[warp_lane] = p;
    warp->sync();
    bool v = false;
    for (int r = 0; r < warp->threads; ++r) v = v || warp->slot[r] != 0;
    warp->sync();
    return v;
  }
};

// body(k, q) on the TPI host threads of each of `groups` groups of one
// warp, q the group's index in the warp.
template <class K, int TPI, class Body>
void on_warp(int groups, Body body) {
  std::vector<Exchange> ex(groups);
  Exchange warp;
  warp.threads = groups * TPI;
  std::vector<std::function<void()>> threads;
  for (int q = 0; q < groups; ++q) {
    ex[q].threads = TPI;
    for (int r = 0; r < TPI; ++r)
      threads.emplace_back([&, q, r] {
        const K k{HostGroup<TPI>{(uint32_t)r, &ex[q], &warp, q * TPI + r}};
        body(k, q);
      });
  }
  Fibers().run(std::move(threads));
}

// ladder_kernels.cu's pt_ladder_horner_kernel, a warp of 32 / TPI lanes at
// a time (a group past the last lane runs the last lane's work and stores
// nothing, as on the card).  With staged (rows == 1), the shared
// coefficients are first converted to Montgomery words by one group, as a
// block stages them.
template <template <class, class> class Kind, class C, int TPI>
void ladder_horner_lanes(const int32_t* coeffs, int64_t rows, int64_t lanes_per_row,
                         const int32_t* x, int32_t* out, int64_t n, int T, int nbits,
                         bool staged) {
  using K = Kind<C, HostGroup<TPI>>;
  constexpr int kGroups = 32 / TPI;
  std::vector<uint32_t> words;
  if (staged) {
    words.resize((size_t)T * K::kCoords * K::N);
    on_warp<K, TPI>(1, [&](const K& k, int) {
      stage_coords(k, words.data(), coeffs, (int64_t)T * K::kCoords, 0, 1);
    });
  }
  for (int64_t lane0 = 0; lane0 < n; lane0 += kGroups) {
    on_warp<K, TPI>(kGroups, [&](const K& k, int q) {
      const int64_t lane = lane0 + q, own = lane < n ? lane : n - 1;
      int32_t* dst = lane < n ? out + lane * K::kCoords * 2 * K::N : nullptr;
      if (staged) {
        ladder_horner_lane(k, StagedCoeffs<K>{words.data()}, (uint32_t)x[own], nbits, T, dst);
      } else {
        const int32_t* row = coeffs + (own / lanes_per_row) * T * K::kCoords * 2 * K::N;
        ladder_horner_lane(k, LimbCoeffs<K>{row}, (uint32_t)x[own], nbits, T, dst);
      }
    });
  }
}

template <template <class, class> class Kind, class C>
int ladder_horner_tpi(int tpi, const int32_t* coeffs, int64_t rows, int64_t lanes_per_row,
                      const int32_t* x, int32_t* out, int64_t n, int T, int nbits, bool staged) {
  switch (tpi) {
    case 2: ladder_horner_lanes<Kind, C, 2>(coeffs, rows, lanes_per_row, x, out, n, T, nbits, staged); return 0;
    case 4: ladder_horner_lanes<Kind, C, 4>(coeffs, rows, lanes_per_row, x, out, n, T, nbits, staged); return 0;
    case 8:
      if constexpr (C::N % 8 == 0) {
        ladder_horner_lanes<Kind, C, 8>(coeffs, rows, lanes_per_row, x, out, n, T, nbits, staged);
        return 0;
      }
      return 1;
    default: return 1;
  }
}
// The kind of chain_kernels.cu at group size TPI, over host threads: a
// group of group.cuh's, or at TPI = 1 chain.cuh's one-thread kinds.
template <template <class, class> class Kind, class C, int TPI>
struct HostKind {
  using type = Kind<C, HostGroup<TPI>>;
  static type make(uint32_t rank, Exchange* group, Exchange* warp, int warp_lane) {
    return type{HostGroup<TPI>{rank, group, warp, warp_lane}};
  }
};
template <class C>
struct HostKind<GroupWs, C, 1> {
  using type = LaneWs<C>;
  static type make(uint32_t, Exchange*, Exchange*, int) { return type{}; }
};
template <class C>
struct HostKind<GroupEd, C, 1> {
  using type = LaneEd;
  static type make(uint32_t, Exchange*, Exchange*, int) { return type{}; }
};

struct HostBlock {
  int n_groups, gid;
  Exchange* bar;
  int groups() const { return n_groups; }
  int group() const { return gid; }
  void sync() const { bar->sync(); }
};

// chain_kernels.cu's pt_fixed_base_kernel: a lane at a time at TPI = 1,
// else a warp of 32 / TPI lanes at a time (a group past the last lane
// runs the last lane's work and stores nothing, as on the card).
template <template <class, class> class Kind, class C, int TPI>
void fixed_base_lanes(const int32_t* table, const int32_t* k, int32_t* out, int64_t n, int nw,
                      int window, int klimbs) {
  using HK = HostKind<Kind, C, TPI>;
  using K = typename HK::type;
  if constexpr (TPI == 1) {
    for (int64_t lane = 0; lane < n; ++lane)
      fixed_base_lane(K{}, table, k + lane * klimbs, nw, window, out + lane * stored_limbs<K>());
  } else {
    constexpr int kGroups = 32 / TPI;
    for (int64_t lane0 = 0; lane0 < n; lane0 += kGroups) {
      on_warp<K, TPI>(kGroups, [&](const K& kind, int q) {
        const int64_t lane = lane0 + q, own = lane < n ? lane : n - 1;
        fixed_base_lane(kind, table, k + own * klimbs, nw, window,
                        lane < n ? out + lane * stored_limbs<K>() : nullptr);
      });
    }
  }
}

// chain_kernels.cu's pt_scalar_mul_kernel: a lane at a time at TPI = 1,
// else a warp of 32 / TPI lanes at a time (a group past the last lane
// runs the last lane's work and stores nothing, as on the card).
template <template <class, class> class Kind, class C, int TPI>
void scalar_mul_lanes(const int32_t* table, int64_t rows, int64_t per_row, const int32_t* k,
                      int32_t* out, int64_t n, int nw, int window, int klimbs) {
  using K = typename HostKind<Kind, C, TPI>::type;
  auto run = [&](const K& kind, int64_t lane) {
    const int64_t own = lane < n ? lane : n - 1;
    scalar_mul_lane(kind, table + (((own / per_row) % rows) << window) * stored_limbs<K>(),
                    k + own * klimbs, nw, window, lane < n ? out + lane * stored_limbs<K>() : nullptr);
  };
  if constexpr (TPI == 1) {
    for (int64_t lane = 0; lane < n; ++lane) run(K{}, lane);
  } else {
    constexpr int kGroups = 32 / TPI;
    for (int64_t lane0 = 0; lane0 < n; lane0 += kGroups)
      on_warp<K, TPI>(kGroups, [&](const K& kind, int q) { run(kind, lane0 + q); });
  }
}

// pt_scalar_mul at group size tpi: 1, 2, 4, or on the 8-word fields 8;
// returns 1 for another size.
template <template <class, class> class Kind, class C, class... A>
int scalar_mul_tpi(int tpi, A... args) {
  switch (tpi) {
    case 1: scalar_mul_lanes<Kind, C, 1>(args...); return 0;
    case 2: scalar_mul_lanes<Kind, C, 2>(args...); return 0;
    case 4: scalar_mul_lanes<Kind, C, 4>(args...); return 0;
    case 8:
      if constexpr (C::N % 8 == 0) {
        scalar_mul_lanes<Kind, C, 8>(args...);
        return 0;
      }
      return 1;
    default: return 1;
  }
}

// chain_kernels.cu's pt_tree_sum_kernel, a block at a time: `threads`
// host threads (at most a warp's 32) in groups of TPI, meeting at a
// barrier for each __syncthreads.
template <template <class, class> class Kind, class C, int TPI>
void tree_sum_blocks(const int32_t* src, int64_t sb, int64_t sj, const int32_t* digits,
                     int64_t dsb, int64_t dsj, int32_t* out, int64_t cols, int64_t m,
                     int levels, int threads) {
  using HK = HostKind<Kind, C, TPI>;
  using K = typename HK::type;
  const int groups = threads / TPI;
  const int64_t chunks = ((m - 1) >> levels) + 1;
  std::vector<uint32_t> words((levels > 0 ? (size_t)1 << (levels - 1) : 1) * point_smem_words<K>());
  for (int64_t b = 0; b < cols * chunks; ++b) {
    const int64_t col = b / chunks, chunk = b % chunks, first = chunk << levels;
    const int64_t rest = m - first, size = (int64_t)1 << levels;
    const Leaves<K> leaves{src + col * sb + first * sj, sj,
                           digits != nullptr ? digits + col * dsb + first * dsj : nullptr, dsj};
    std::vector<Exchange> ex(groups);
    Exchange warp, bar;
    warp.threads = bar.threads = groups * TPI;
    std::vector<std::function<void()>> ts;
    for (int q = 0; q < groups; ++q) {
      ex[q].threads = TPI;
      for (int r = 0; r < TPI; ++r)
        ts.emplace_back([&, q, r] {
          const K kind = HK::make((uint32_t)r, &ex[q], &warp, q * TPI + r);
          tree_block(kind, HostBlock{groups, q, &bar}, words.data(), leaves,
                     rest < size ? rest : size, levels, out + b * stored_limbs<K>());
        });
    }
    Fibers().run(std::move(ts));
  }
}

// Each chained kernel at group size tpi: 1, or where chain_kernels.cu
// builds a group variant of it (kFixedGroups, kTreeGroups) 2, 4, or on
// the 8-word fields 8; returns 1 for another size.
template <template <class, class> class Kind, class C, bool kFixedGroups, bool kTreeGroups>
struct Chain {
  template <int TPI>
  static int run(bool tree, const int32_t* a, int64_t sb, int64_t sj, const int32_t* digits,
                 int64_t dsb, int64_t dsj, int32_t* out, int64_t n, int64_t m, int levels,
                 int nw, int window, int klimbs, int threads) {
    if constexpr (TPI == 1 || kTreeGroups) {
      if (tree) {
        tree_sum_blocks<Kind, C, TPI>(a, sb, sj, digits, dsb, dsj, out, n, m, levels, threads);
        return 0;
      }
    }
    if constexpr (TPI == 1 || kFixedGroups) {
      if (!tree) {
        fixed_base_lanes<Kind, C, TPI>(a, digits, out, n, nw, window, klimbs);
        return 0;
      }
    }
    return 1;
  }
  template <class... A>
  static int at(int tpi, A... args) {
    if constexpr (!kFixedGroups && !kTreeGroups) return tpi == 1 ? run<1>(args...) : 1;
    else {
      switch (tpi) {
        case 1: return run<1>(args...);
        case 2: return run<2>(args...);
        case 4: return run<4>(args...);
        case 8:
          if constexpr (C::N % 8 == 0) return run<8>(args...);
          return 1;
        default: return 1;
      }
    }
  }
};

template <class... A>
int chain_at(int curve, int tpi, A... args) {
  switch (curve) {
    case 0: return Chain<GroupWs, Secp256k1, true, false>::at(tpi, args...);
    case 1: return Chain<GroupWs, Bls12381, true, true>::at(tpi, args...);
    case 2: return Chain<GroupEd, Edwards25519, false, false>::at(tpi, args...);
    default: return 1;
  }
}

// A warp's mma as the PTX ISA lays out its fragments (m16n8k32, .u8 A
// row-major, .u8 B column-major, .s32 C and D; groupID g = lane / 4,
// threadID_in_group t = lane % 4, element i of a register in its byte
// i % 4): every lane posts its A and B registers, lane 0 assembles the
// two tiles from the tables and multiplies them, and every lane adds its
// four elements of the product to its d.
struct MmaExchange {
  Exchange ex;
  uint32_t a[32][4], b[32][2];
  int32_t d[16][8];
};

struct HostWarp {
  uint32_t* buf;
  int lane;
  MmaExchange* x;
  void sync() const { x->ex.sync(); }
  void mma(uint32_t d[4], const uint32_t a[4], const uint32_t b[2]) const {
    for (int i = 0; i < 4; ++i) x->a[lane][i] = a[i];
    x->b[lane][0] = b[0];
    x->b[lane][1] = b[1];
    x->ex.sync();
    if (lane == 0) {
      uint32_t A[16][32], B[32][8];
      for (int l = 0; l < 32; ++l) {
        const int g = l >> 2, t = l & 3;
        for (int i = 0; i < 16; ++i) {  // a_i
          const int row = (i < 4 || (i >= 8 && i < 12)) ? g : g + 8;
          const int col = t * 4 + (i & 3) + (i >= 8 ? 16 : 0);
          A[row][col] = (x->a[l][i / 4] >> (8 * (i % 4))) & 0xFFu;
        }
        for (int i = 0; i < 8; ++i) {  // b_i
          const int row = t * 4 + (i & 3) + (i >= 4 ? 16 : 0);
          B[row][g] = (x->b[l][i / 4] >> (8 * (i % 4))) & 0xFFu;
        }
      }
      for (int r = 0; r < 16; ++r)
        for (int c = 0; c < 8; ++c) {
          uint32_t sum = 0;
          for (int k = 0; k < 32; ++k) sum += A[r][k] * B[k][c];
          x->d[r][c] = (int32_t)sum;
        }
    }
    x->ex.sync();
    const int g = lane >> 2, t = lane & 3;
    for (int i = 0; i < 4; ++i) d[i] += (uint32_t)x->d[i < 2 ? g : g + 8][t * 2 + (i & 1)];
  }
};

// body(w) on each lane of a warp of 32 fibers, sharing one staging buffer.
template <int L, class Body>
void on_mxu_warp(Body body) {
  MmaExchange x;
  x.ex.threads = 32;
  std::vector<uint32_t> buf(MxuTiles<L>::kWords);
  std::vector<std::function<void()>> threads;
  for (int l = 0; l < 32; ++l) threads.emplace_back([&, l] { body(HostWarp{buf.data(), l, &x}); });
  Fibers().run(std::move(threads));
}

// mxu_warp.cuh's multiply-reduce, the one that mxu_batch_inv's column runs,
// a warp of 32 lanes at a time (a lane past n runs lane n - 1 and stores
// nothing).  mode 0: (a, b) -> a * b mod p;
// mode 1: 2L columns at a -> their value mod p (steps 2 to 8).
template <int L>
void mxu_warp_lanes(int mode, const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                    const uint32_t* foldm, const MulRed& k) {
  for (int64_t base = 0; base < n; base += 32) {
    on_mxu_warp<L>([&](const HostWarp& w) {
      MxuFrags<L> fr;
      mxu_load_frags<L>(fr, foldm, w.lane);
      const int64_t i = base + w.lane, own = i < n ? i : n - 1;
      uint32_t r[L];
      if (mode == 0) {
        uint32_t x[L], y[L];
        load_limbs<L>(a + own * L, x);
        load_limbs<L>(b + own * L, y);
        mxu_warp_mul<L>(w, x, y, r, k, fr);
      } else {
        uint32_t col[2 * L];
        for (int j = 0; j < 2 * L; ++j) col[j] = (uint32_t)a[own * 2 * L + j];
        mxu_warp_reduce<L>(w, col, r, k, fr);
      }
      if (i < n) store_limbs<L>(out + i * L, r);
    });
  }
}

// mxu_kernels.cu's mxu_batch_inv_kernel, a warp of 32 columns at a time.
template <int L>
void mxu_batch_inv_warps(const int32_t* x, int32_t* out, int64_t rows, int64_t cols,
                         const uint32_t* foldm, const MulRed& k, const int32_t* chain,
                         int chain_len, int npow) {
  for (int64_t base = 0; base < cols; base += 32) {
    on_mxu_warp<L>([&](const HostWarp& w) {
      MxuFrags<L> fr;
      mxu_load_frags<L>(fr, foldm, w.lane);
      const int64_t col = base + w.lane;
      mxu_batch_inv_column<L>(w, x + col * L, out + col * L, rows, cols * L, chain, chain_len,
                              npow, k, fr);
    });
  }
}

// pippenger_kernels.cu's pt_bucket_sum_kernel, a lane at a time: lane
// ((w nb + e - 1) bp + q pp + r) over kb digit blocks of batch / kb rows,
// each padded to pp, a multiple of a warp's 32.
template <template <class, class> class Kind, class C>
void bucket_sum_lanes(const int32_t* pts, int64_t sb, int64_t sj, const int32_t* order,
                      const int32_t* starts, int32_t* out, int64_t batch, int64_t m, int nw,
                      int nb, int64_t kb) {
  using K = typename HostKind<Kind, C, 1>::type;
  const int64_t per = batch / kb, pp = (per + 31) / 32 * 32, bp = kb * pp;
  for (int64_t lane = 0; lane < (int64_t)nw * nb * bp; ++lane) {
    const int64_t bq = lane % bp, bucket = lane / bp;
    const int64_t q = bq / pp, r = bq % pp;
    const int w = (int)(bucket / nb), e = (int)(bucket % nb) + 1;
    const int64_t list = q * nw + w;
    const int32_t* st = starts + list * (nb + 2);
    const int64_t own = q * per + (r < per ? r : per - 1);
    bucket_sum_lane(K{}, pts + own * sb, sj, order + list * m, st[e], st[e + 1] - st[e],
                    r < per ? out + (bucket * batch + q * per + r) * stored_limbs<K>() : nullptr);
  }
}

// pippenger_kernels.cu's pt_bucket_close_kernel: lane (w bp + b).
template <template <class, class> class Kind, class C, int TPI>
void bucket_close_lanes(const int32_t* src, int64_t sb, int64_t sw, int64_t se, int32_t* out,
                        int64_t batch, int nw, int nb) {
  using K = typename HostKind<Kind, C, TPI>::type;
  constexpr int kGroups = 32 / TPI;
  const int64_t bp = (batch + kGroups - 1) / kGroups * kGroups;
  auto run = [&](const K& kind, int64_t lane) {
    const int64_t b = lane % bp, own = b < batch ? b : batch - 1;
    const int w = (int)(lane / bp);
    bucket_close_lane(kind, src + own * sb + w * sw, se, nb,
                      b < batch ? out + (b * nw + w) * stored_limbs<K>() : nullptr);
  };
  const int64_t lanes = (int64_t)nw * bp;
  if constexpr (TPI == 1) {
    for (int64_t lane = 0; lane < lanes; ++lane) run(K{}, lane);
  } else {
    for (int64_t lane0 = 0; lane0 < lanes; lane0 += kGroups)
      on_warp<K, TPI>(kGroups, [&](const K& kind, int q) { run(kind, lane0 + q); });
  }
}

// The bucket close at group size tpi: 1, or where pippenger_kernels.cu
// builds a group variant of it (kGroups) 2, 4, or on the 8-word fields 8;
// returns 1 for another size.
template <template <class, class> class Kind, class C, bool kGroups, class... A>
int close_tpi(int tpi, A... args) {
  switch (tpi) {
    case 1: bucket_close_lanes<Kind, C, 1>(args...); return 0;
    case 2:
      if constexpr (kGroups) {
        bucket_close_lanes<Kind, C, 2>(args...);
        return 0;
      }
      return 1;
    case 4:
      if constexpr (kGroups) {
        bucket_close_lanes<Kind, C, 4>(args...);
        return 0;
      }
      return 1;
    case 8:
      if constexpr (kGroups && C::N % 8 == 0) {
        bucket_close_lanes<Kind, C, 8>(args...);
        return 0;
      }
      return 1;
    default: return 1;
  }
}
}  // namespace

extern "C" {

// field: the ids of field.cuh; returns 1 for an unknown id.
int host_mod_madd(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out, int64_t n,
                  int field) {
  switch (field) {
    case kSecpP: mod_madd_lanes<kSecpP>(a, b, c, out, n); return 0;
    case kSecpN: mod_madd_lanes<kSecpN>(a, b, c, out, n); return 0;
    case kEdP: mod_madd_lanes<kEdP>(a, b, c, out, n); return 0;
    case kEdL: mod_madd_lanes<kEdL>(a, b, c, out, n); return 0;
    case kBlsP: mod_madd_lanes<kBlsP>(a, b, c, out, n); return 0;
    case kBlsR: mod_madd_lanes<kBlsR>(a, b, c, out, n); return 0;
    default: return 1;
  }
}

int host_mod_mul(const int32_t* a, const int32_t* b, int32_t* out, int64_t n, int field) {
  switch (field) {
    case kSecpP: mod_mul_lanes<kSecpP>(a, b, out, n); return 0;
    case kSecpN: mod_mul_lanes<kSecpN>(a, b, out, n); return 0;
    case kEdP: mod_mul_lanes<kEdP>(a, b, out, n); return 0;
    case kEdL: mod_mul_lanes<kEdL>(a, b, out, n); return 0;
    case kBlsP: mod_mul_lanes<kBlsP>(a, b, out, n); return 0;
    case kBlsR: mod_mul_lanes<kBlsR>(a, b, out, n); return 0;
    default: return 1;
  }
}

// The constants as dkg_mxu_mod_mul takes them; returns 1 for another
// limb count.
int host_mxu_mod_mul(int mode, const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                     int limbs, const void* foldm, const uint32_t* qtable, const uint32_t* c,
                     const uint32_t* np, int n_split, int shift_e) {
  const MulRed k{(const uint32_t*)foldm, qtable, c, np, n_split, shift_e};
  switch (limbs) {
    case 16: mxu_lanes<16>(mode, a, b, out, n, k); return 0;
    case 24: mxu_lanes<24>(mode, a, b, out, n, k); return 0;
    default: return 1;
  }
}

void host_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  add_lanes<Secp256k1>(p, q, out, n);
}

void host_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  madd_lanes<Secp256k1>(p, q, out, n);
}

void host_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                         int n_doubles) {
  window_step_lanes<Secp256k1>(acc, entry, out, n, n_doubles);
}

void host_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                            int32_t* out, int64_t n, int nbits) {
  ladder_lanes<Secp256k1>(p, addend, x, out, n, nbits);
}

void host_pt_double(const int32_t* p, int32_t* out, int64_t n, int n_doubles) {
  double_lanes<Secp256k1>(p, out, n, n_doubles);
}

void host_bls_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  add_lanes<Bls12381>(p, q, out, n);
}

void host_bls_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  madd_lanes<Bls12381>(p, q, out, n);
}

void host_bls_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                             int n_doubles) {
  window_step_lanes<Bls12381>(acc, entry, out, n, n_doubles);
}

void host_bls_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                                int32_t* out, int64_t n, int nbits) {
  ladder_lanes<Bls12381>(p, addend, x, out, n, nbits);
}

void host_bls_pt_double(const int32_t* p, int32_t* out, int64_t n, int n_doubles) {
  double_lanes<Bls12381>(p, out, n, n_doubles);
}

void host_ed_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane)
    ed_add_lane(p + lane * kEdPointWords, q + lane * kEdPointWords, out + lane * kEdPointWords);
}

void host_ed_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane)
    ed_madd_lane(p + lane * kEdPointWords, q + lane * kEdPointWords, out + lane * kEdPointWords);
}

void host_ed_pt_double(const int32_t* p, int32_t* out, int64_t n, int n_doubles) {
  for (int64_t lane = 0; lane < n; ++lane)
    ed_double_lane(p + lane * kEdPointWords, n_doubles, out + lane * kEdPointWords);
}

void host_ed_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                            int n_doubles) {
  for (int64_t lane = 0; lane < n; ++lane)
    ed_window_step_lane(acc + lane * kEdPointWords, entry + lane * kEdPointWords, n_doubles,
                        out + lane * kEdPointWords);
}

void host_ed_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                               int32_t* out, int64_t n, int nbits) {
  for (int64_t lane = 0; lane < n; ++lane)
    ed_ladder_lane(p + lane * kEdPointWords, addend + lane * kEdPointWords, (uint32_t)x[lane],
                   nbits, out + lane * kEdPointWords);
}

void host_bucket_accumulate(const int32_t* pts, const int32_t* digits, int32_t* out,
                            int64_t batch, int64_t m, int nw, int window,
                            int64_t dig_batch_stride) {
  bucket_lanes<SecpCurve>(pts, digits, out, batch, m, nw, window, dig_batch_stride);
}

void host_ed_bucket_accumulate(const int32_t* pts, const int32_t* digits, int32_t* out,
                               int64_t batch, int64_t m, int nw, int window,
                               int64_t dig_batch_stride) {
  bucket_lanes<EdCurve>(pts, digits, out, batch, m, nw, window, dig_batch_stride);
}

void host_bls_bucket_accumulate(const int32_t* pts, const int32_t* digits, int32_t* out,
                                int64_t batch, int64_t m, int nw, int window,
                                int64_t dig_batch_stride) {
  bucket_lanes<BlsCurve>(pts, digits, out, batch, m, nw, window, dig_batch_stride);
}

// field: the ids of field.cuh; returns 1 for an unknown id.
int host_mod_madd_horner(const int32_t* coeffs, int64_t coeff_stride, const int32_t* xs,
                         int64_t xs_stride, int32_t* out, int64_t rows, int64_t npts, int T,
                         int field) {
  switch (field) {
    case kSecpP: horner_lanes<kSecpP>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T); return 0;
    case kSecpN: horner_lanes<kSecpN>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T); return 0;
    case kEdP: horner_lanes<kEdP>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T); return 0;
    case kEdL: horner_lanes<kEdL>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T); return 0;
    case kBlsP: horner_lanes<kBlsP>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T); return 0;
    case kBlsR: horner_lanes<kBlsR>(coeffs, coeff_stride, xs, xs_stride, out, rows, npts, T); return 0;
    default: return 1;
  }
}

int host_mod_madd_dot(const int32_t* w, const int32_t* v, int32_t* out, int64_t m, int64_t K,
                      int slices, int field) {
  switch (field) {
    case kSecpP: dot_lanes<kSecpP>(w, v, out, m, K, slices); return 0;
    case kSecpN: dot_lanes<kSecpN>(w, v, out, m, K, slices); return 0;
    case kEdP: dot_lanes<kEdP>(w, v, out, m, K, slices); return 0;
    case kEdL: dot_lanes<kEdL>(w, v, out, m, K, slices); return 0;
    case kBlsP: dot_lanes<kBlsP>(w, v, out, m, K, slices); return 0;
    case kBlsR: dot_lanes<kBlsR>(w, v, out, m, K, slices); return 0;
    default: return 1;
  }
}

// curve: 0 secp256k1, 1 BLS12-381 G1, 2 edwards25519; tpi: 2, 4 or (on
// the 8-word fields) 8 threads a lane.  Returns 1 for another curve or group size.
int host_pt_ladder_horner(int curve, int tpi, const int32_t* coeffs, int64_t rows,
                          int64_t lanes_per_row, const int32_t* x, int32_t* out, int64_t n, int T,
                          int nbits, int staged) {
  switch (curve) {
    case 0: return ladder_horner_tpi<GroupWs, Secp256k1>(tpi, coeffs, rows, lanes_per_row, x, out, n, T, nbits, staged);
    case 1: return ladder_horner_tpi<GroupWs, Bls12381>(tpi, coeffs, rows, lanes_per_row, x, out, n, T, nbits, staged);
    case 2: return ladder_horner_tpi<GroupEd, Edwards25519>(tpi, coeffs, rows, lanes_per_row, x, out, n, T, nbits, staged);
    default: return 1;
  }
}

// curve: 0 secp256k1, 1 BLS12-381 G1, 2 edwards25519; tpi as Chain::at
// takes it.  table (nw, 2^window, C, L), k (n, klimbs).
int host_pt_fixed_base(int curve, int tpi, const int32_t* table, const int32_t* k, int32_t* out,
                       int64_t n, int nw, int window, int klimbs) {
  return chain_at(curve, tpi, false, table, (int64_t)0, (int64_t)0, k, (int64_t)0, (int64_t)0, out,
                  n, (int64_t)0, 0, nw, window, klimbs, 0);
}

// x, out (rows, cols, L); field: 0, 2 or 4 (the base fields of
// inv_kernels.cu), else returns 1.
int host_mod_batch_inv(const int32_t* x, int32_t* out, int64_t rows, int64_t cols,
                       const int32_t* chain, int chain_len, int npow, int field) {
  if (rows < 1 || chain_len < 1 || npow < 1 || npow > kInvMaxPowers) return 1;
  switch (field) {
    case kSecpP: batch_inv_columns<kSecpP>(x, out, rows, cols, chain, chain_len, npow); return 0;
    case kEdP: batch_inv_columns<kEdP>(x, out, rows, cols, chain, chain_len, npow); return 0;
    case kBlsP: batch_inv_columns<kBlsP>(x, out, rows, cols, chain, chain_len, npow); return 0;
    default: return 1;
  }
}

// curve: 0 secp256k1, 1 BLS12-381 G1, 2 edwards25519; tpi: 1 (one thread
// a lane), 2, 4 or (on the 8-word fields) 8.  table rows (rows, 2^window,
// C, L), lane i's row (i / per_row) % rows; k (n, klimbs).
int host_pt_scalar_mul(int curve, int tpi, const int32_t* table, int64_t rows, int64_t per_row,
                       const int32_t* k, int32_t* out, int64_t n, int nw, int window, int klimbs) {
  if (rows < 1 || per_row < 1 || window < 1 || 16 % window != 0 || nw * window > klimbs * 16) return 1;
  switch (curve) {
    case 0: return scalar_mul_tpi<GroupWs, Secp256k1>(tpi, table, rows, per_row, k, out, n, nw, window, klimbs);
    case 1: return scalar_mul_tpi<GroupWs, Bls12381>(tpi, table, rows, per_row, k, out, n, nw, window, klimbs);
    case 2: return scalar_mul_tpi<GroupEd, Edwards25519>(tpi, table, rows, per_row, k, out, n, nw, window, klimbs);
    default: return 1;
  }
}

// cols columns of m leaves (column b's leaf j at src + b sb + j sj, with
// digits under digits + b dsb + j dsj), chunks of 2^levels leaves, blocks
// of `threads` host threads -> out (cols, chunks, C, L).
int host_pt_tree_sum(int curve, int tpi, int threads, const int32_t* src, int64_t sb, int64_t sj,
                     const int32_t* digits, int64_t dsb, int64_t dsj, int32_t* out, int64_t cols,
                     int64_t m, int levels) {
  if (threads < tpi || threads > 32 || threads % tpi != 0 || m < 1 || levels < 0) return 1;
  return chain_at(curve, tpi, true, src, sb, sj, digits, dsb, dsj, out, cols, m, levels, 0, 0, 0,
                  threads);
}

// The tensor-core multiply-reduce over warps of 32 fibers: mode 0 a * b,
// mode 1 columns at a (as host_mxu_mod_mul); the constants as
// dkg_mxu_mod_mul takes them.  Returns 1 for another limb count.
int host_mxu_warp_mod_mul(int mode, const int32_t* a, const int32_t* b, int32_t* out, int64_t n,
                          int limbs, const void* foldm, const uint32_t* qtable, const uint32_t* c,
                          const uint32_t* np, int n_split, int shift_e) {
  const MulRed k{nullptr, qtable, c, np, n_split, shift_e};
  const uint32_t* f = (const uint32_t*)foldm;
  switch (limbs) {
    case 16: mxu_warp_lanes<16>(mode, a, b, out, n, f, k); return 0;
    case 24: mxu_warp_lanes<24>(mode, a, b, out, n, f, k); return 0;
    default: return 1;
  }
}

// x, out (rows, cols, limbs), cols a multiple of 32; the constants and
// chain as dkg_mxu_batch_inv takes them.  Returns 1 for another shape.
int host_mxu_batch_inv(const int32_t* x, int32_t* out, int64_t rows, int64_t cols, int limbs,
                       const void* foldm, const uint32_t* qtable, const uint32_t* c,
                       const uint32_t* np, int n_split, int shift_e, const int32_t* chain,
                       int chain_len, int npow) {
  if (rows < 1 || cols % 32 != 0 || chain_len < 1 || npow < 1 || npow > kInvMaxPowers) return 1;
  const MulRed k{nullptr, qtable, c, np, n_split, shift_e};
  const uint32_t* f = (const uint32_t*)foldm;
  switch (limbs) {
    case 16: mxu_batch_inv_warps<16>(x, out, rows, cols, f, k, chain, chain_len, npow); return 0;
    case 24: mxu_batch_inv_warps<24>(x, out, rows, cols, f, k, chain, chain_len, npow); return 0;
    default: return 1;
  }
}

// curve: 0 secp256k1, 1 BLS12-381 G1, 2 edwards25519.  Points: row b's
// point j at pts + b sb + j sj; the rows kb blocks of batch / kb, each
// with its order (nw, m) and starts (nw, nb + 2), one after the other;
// out (nw, nb, batch, C, L).  host_pt_bucket_sum: kb = 1.
int host_pt_bucket_sum_convoy(int curve, const int32_t* pts, int64_t sb, int64_t sj,
                              const int32_t* order, const int32_t* starts, int32_t* out,
                              int64_t batch, int64_t m, int nw, int nb, int64_t kb) {
  if (batch < 1 || nw < 1 || nb < 1 || kb < 1 || batch % kb) return 1;
  switch (curve) {
    case 0: bucket_sum_lanes<GroupWs, Secp256k1>(pts, sb, sj, order, starts, out, batch, m, nw, nb, kb); return 0;
    case 1: bucket_sum_lanes<GroupWs, Bls12381>(pts, sb, sj, order, starts, out, batch, m, nw, nb, kb); return 0;
    case 2: bucket_sum_lanes<GroupEd, Edwards25519>(pts, sb, sj, order, starts, out, batch, m, nw, nb, kb); return 0;
    default: return 1;
  }
}

int host_pt_bucket_sum(int curve, const int32_t* pts, int64_t sb, int64_t sj, const int32_t* order,
                       const int32_t* starts, int32_t* out, int64_t batch, int64_t m, int nw,
                       int nb) {
  return host_pt_bucket_sum_convoy(curve, pts, sb, sj, order, starts, out, batch, m, nw, nb, 1);
}

// curve as above; tpi as close_tpi takes it (no group on edwards25519).
// Buckets: row b's bucket e (1 .. nb) of window w at src + b sb + w sw +
// (e - 1) se; out (batch, nw, C, L).
int host_pt_bucket_close(int curve, int tpi, const int32_t* src, int64_t sb, int64_t sw, int64_t se,
                         int32_t* out, int64_t batch, int nw, int nb) {
  if (batch < 1 || nw < 1 || nb < 1) return 1;
  switch (curve) {
    case 0: return close_tpi<GroupWs, Secp256k1, true>(tpi, src, sb, sw, se, out, batch, nw, nb);
    case 1: return close_tpi<GroupWs, Bls12381, true>(tpi, src, sb, sw, se, out, batch, nw, nb);
    case 2: return close_tpi<GroupEd, Edwards25519, false>(tpi, src, sb, sw, se, out, batch, nw, nb);
    default: return 1;
  }
}

}  // extern "C"
