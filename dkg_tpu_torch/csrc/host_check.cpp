// The kernels' per-lane bodies compiled for the host, one loop over lanes
// in place of the grid.  The CPU tests build this file with the host
// compiler (g++ -O1 -shared -fPIC) and hold every entry against the plain
// PyTorch version of its kernel: it runs the same field.cuh, point.cuh,
// edwards.cuh and bucket.cuh code that field_kernels.cu, point_kernels.cu,
// edwards_kernels.cu, double_kernels.cu and bucket_kernels.cu run on the
// card, the three reductions (fold at 2^256, fold at 2^255, Barrett)
// included.
#include "bucket.cuh"

using namespace dkg;

namespace {
constexpr int kPointWords = kCoords * kLimbs;
constexpr int kEdPointWords = kEdCoords * kLimbs;

template <int F>
void mod_madd_lanes(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out,
                    int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane) {
    uint32_t x[kWords], y[kWords], z[kWords], r[kWords];
    load16(a + lane * kLimbs, x);
    load16(b + lane * kLimbs, y);
    load16(c + lane * kLimbs, z);
    fmadd<F>(r, x, y, z);
    store16(out + lane * kLimbs, r);
  }
}

// Every bucket (b, w, e) of bucket_kernels.cu, one after another: the
// same bucket_fold over the whole digit column of window w.
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
    default: return 1;
  }
}

void host_pt_add(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane)
    add_lane(p + lane * kPointWords, q + lane * kPointWords, out + lane * kPointWords);
}

void host_pt_madd(const int32_t* p, const int32_t* q, int32_t* out, int64_t n) {
  for (int64_t lane = 0; lane < n; ++lane)
    madd_lane(p + lane * kPointWords, q + lane * kPointWords, out + lane * kPointWords);
}

void host_pt_window_step(const int32_t* acc, const int32_t* entry, int32_t* out, int64_t n,
                         int n_doubles) {
  for (int64_t lane = 0; lane < n; ++lane)
    window_step_lane(acc + lane * kPointWords, entry + lane * kPointWords, n_doubles,
                     out + lane * kPointWords);
}

void host_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                            int32_t* out, int64_t n, int nbits) {
  for (int64_t lane = 0; lane < n; ++lane)
    ladder_lane(p + lane * kPointWords, addend + lane * kPointWords, (uint32_t)x[lane], nbits,
                out + lane * kPointWords);
}

void host_pt_double(const int32_t* p, int32_t* out, int64_t n, int n_doubles) {
  for (int64_t lane = 0; lane < n; ++lane)
    double_lane(p + lane * kPointWords, n_doubles, out + lane * kPointWords);
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

void host_ed_pt_ladder_mul_add(const int32_t* p, const int32_t* addend, const int32_t* x,
                               int32_t* out, int64_t n, int nbits) {
  for (int64_t lane = 0; lane < n; ++lane)
    ed_ladder_lane(p + lane * kEdPointWords, addend + lane * kEdPointWords, (uint32_t)x[lane],
                   nbits, out + lane * kEdPointWords);
}

void host_bucket_accumulate(const int32_t* pts, const int32_t* digits, int32_t* out,
                            int64_t batch, int64_t m, int nw, int window,
                            int64_t dig_batch_stride) {
  bucket_lanes<WsCurve>(pts, digits, out, batch, m, nw, window, dig_batch_stride);
}

void host_ed_bucket_accumulate(const int32_t* pts, const int32_t* digits, int32_t* out,
                               int64_t batch, int64_t m, int nw, int window,
                               int64_t dig_batch_stride) {
  bucket_lanes<EdCurve>(pts, digits, out, batch, m, nw, window, dig_batch_stride);
}

}  // extern "C"
