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
#include "bucket.cuh"
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

}  // extern "C"
