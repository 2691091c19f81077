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
// 32 host threads: its TPI threads a lane meet at a barrier for each
// shuffle and ballot, and all 32 for each of the warp's votes.
#include <atomic>
#include <thread>
#include <vector>

#include "bucket.cuh"
#include "group.cuh"
#include "horner.cuh"
#include "mxu.cuh"

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

// A warp as host threads: each group of TPI threads shuffles and ballots
// through its own slots and barrier, and the warp's votes (any) go
// through one shared by all its threads.  Each exchange writes the
// thread's value to a slot, meets the others at the barrier, reads, and
// meets them again before the slots are reused.
struct Exchange {
  int threads;
  std::atomic<int> count{0}, generation{0};
  uint32_t slot[32];
  void sync() {
    const int gen = generation.load(std::memory_order_acquire);
    if (count.fetch_add(1, std::memory_order_acq_rel) == threads - 1) {
      count.store(0, std::memory_order_relaxed);
      generation.fetch_add(1, std::memory_order_release);
    } else {
      while (generation.load(std::memory_order_acquire) == gen) std::this_thread::yield();
    }
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
  std::vector<std::thread> threads;
  for (int q = 0; q < groups; ++q) {
    ex[q].threads = TPI;
    for (int r = 0; r < TPI; ++r)
      threads.emplace_back([&, q, r] {
        const K k{HostGroup<TPI>{(uint32_t)r, &ex[q], &warp, q * TPI + r}};
        body(k, q);
      });
  }
  for (auto& t : threads) t.join();
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

}  // extern "C"
