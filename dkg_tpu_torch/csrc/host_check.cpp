// The kernels' per-lane bodies compiled for the host, one loop over lanes
// in place of the grid.  The CPU tests build this file with the host
// compiler (g++ -O1 -shared -fPIC) and hold every entry against the plain
// PyTorch version of its kernel: it runs the same field.cuh and point.cuh
// code that field_kernels.cu and point_kernels.cu run on the card.
#include "point.cuh"

using namespace dkg;

namespace {
constexpr int kPointWords = kCoords * kLimbs;
}

extern "C" {

void host_mod_madd(const int32_t* a, const int32_t* b, const int32_t* c, int32_t* out, int64_t n,
                   int field) {
  for (int64_t lane = 0; lane < n; ++lane) {
    uint32_t x[kWords], y[kWords], z[kWords], r[kWords];
    load16(a + lane * kLimbs, x);
    load16(b + lane * kLimbs, y);
    load16(c + lane * kLimbs, z);
    if (field == kBase) {
      fmadd<kBase>(r, x, y, z);
    } else {
      fmadd<kScalar>(r, x, y, z);
    }
    store16(out + lane * kLimbs, r);
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

}  // extern "C"
